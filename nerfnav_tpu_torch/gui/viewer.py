"""Interactive viewer: an orbit camera, the adaptive train / render loop and a
web page to drive them.

Counterpart of nerfnav_tpu/gui/viewer.py:
- `OrbitCamera`: orbit by drag, zoom by wheel, pan; the pose and the
  intrinsics from fovy.
- `NeRFGUI`: train chunks sized toward TRAIN_BUDGET_S (0.5 s; the first
  chunk 16 steps) through `Trainer.train_gui`, and frames through
  `Trainer.test_gui`: a fast pass at a downscale in [1/4, 1] sized toward
  RENDER_BUDGET_S (0.2 s) after every camera move, then, while the camera is
  idle, refinement passes at twice the previous resolution up to full
  resolution, then anti-aliasing passes with Halton subpixel offsets averaged
  into the frame, counted as spp up to max_spp.
- The widgets: training on / off, reset, checkpoint, mesh export, background,
  fovy, dt_gamma, max spp, dynamic resolution and the crop box.
- `serve`: a stdlib http.server that streams the frames as JPEG (cv2) to
  the page in `_PAGE`; reach it over SSH port forwarding (port 7860 from
  `main_nerf --gui`).

The frame is rendered on the Trainer's device, in the request's thread under
the server's lock.
"""

import contextlib
import dataclasses
import json
import threading

import numpy as np


class OrbitCamera:
    """An orbit camera around `center` at `radius` (azimuth, elevation in
    radians), in the framework's camera convention (+z forward, +y down)."""

    def __init__(self, W, H, r=2.0, fovy=60.0):
        self.W, self.H = W, H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.azimuth = 0.0
        self.elevation = 0.0

    @property
    def intrinsics(self):
        focal = self.H / (2 * np.tan(np.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W / 2, self.H / 2], np.float32)

    @property
    def pose(self):
        """(4, 4) camera-to-world."""
        ca, sa = np.cos(self.azimuth), np.sin(self.azimuth)
        ce, se = np.cos(self.elevation), np.sin(self.elevation)
        eye = self.center + self.radius * np.array([ca * ce, sa * ce, se], np.float32)
        forward = self.center - eye
        forward = forward / (np.linalg.norm(forward) + 1e-9)
        up = np.array([0.0, 0.0, 1.0], np.float32)
        right = np.cross(forward, up)
        right = right / (np.linalg.norm(right) + 1e-9)
        down = np.cross(forward, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0] = right
        pose[:3, 1] = down
        pose[:3, 2] = forward
        pose[:3, 3] = eye
        return pose

    def orbit(self, dx, dy):
        self.azimuth -= dx * 0.005
        self.elevation = float(np.clip(self.elevation + dy * 0.005, -1.5, 1.5))

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0.0):
        p = self.pose
        self.center += 1e-3 * self.radius * (p[:3, 0] * dx + p[:3, 1] * dy + p[:3, 2] * dz)


def _halton_offset(i: int):
    """The centred (base 2, base 3) Halton subpixel offset in [-0.5, 0.5)^2."""

    def radical_inverse(n, base):
        inv, f = 0.0, 1.0 / base
        while n > 0:
            inv += f * (n % base)
            n //= base
            f /= base
        return inv

    return (radical_inverse(i, 2) - 0.5, radical_inverse(i, 3) - 0.5)


def encode_jpeg(img):
    """An (H, W, 3) RGB image in [0, 1] as JPEG bytes (cv2)."""
    import cv2

    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img8, cv2.COLOR_RGB2BGR))
    if not ok:
        raise RuntimeError("cv2 could not encode the frame as JPEG")
    return buf.tobytes()


class NeRFGUI:
    """The adaptive train / render loop and its web frontend."""

    TRAIN_BUDGET_S = 0.5
    RENDER_BUDGET_S = 0.2

    def __init__(self, trainer, train_ds=None, W=800, H=800, radius=2.0,
                 fovy=60.0, max_spp=64, bg_color=1.0):
        self.trainer = trainer
        self.train_ds = train_ds
        self.cam = OrbitCamera(W, H, r=radius, fovy=fovy)
        self.training = train_ds is not None
        self.max_spp = max_spp
        self.bg_color = bg_color
        self.downscale = 0.25
        self.train_steps = 16
        self.spp = 0
        self._acc = None
        self._acc_scale = 0.0   # the resolution scale of the current frame
        self._dirty = True
        # widget state: the crop box [xmin, ymin, zmin, xmax, ymax, zmax]
        b = getattr(trainer.cfg, "bound", 1.0)
        self.aabb = [-b, -b, -b, b, b, b]
        self._full_aabb = list(self.aabb)
        self.dynamic_resolution = True
        self.status = ""
        self._cuda = None   # the Trainer's card, index pinned in this thread
        dev = getattr(trainer, "device", None)
        if dev is not None and dev.type == "cuda":
            import torch

            self._cuda = dev.index if dev.index is not None else torch.cuda.current_device()

    # ------------------------------------------------------------- widget ops
    def set_option(self, name, value):
        """Apply a widget change; an unknown name raises KeyError."""
        if name == "bg_color":
            self.bg_color = float(value)
        elif name == "fovy":
            self.cam.fovy = float(value)
        elif name == "max_spp":
            self.max_spp = int(value)
        elif name == "dynamic_resolution":
            self.dynamic_resolution = bool(value)
            if not self.dynamic_resolution:
                self.downscale = 1.0
        elif name == "dt_gamma":
            # a new march config: the render's plans and the training march
            # configs cached from the old one are dropped with it, so the
            # next train chunk and the next frame both march with the value
            tr = self.trainer
            if tr.march_cfg is not None:
                tr.march_cfg = dataclasses.replace(tr.march_cfg, dt_gamma=float(value))
                tr.invalidate_render_cache()
        elif name.startswith("aabb_"):
            axes = {"xmin": 0, "ymin": 1, "zmin": 2, "xmax": 3, "ymax": 4, "zmax": 5}
            self.aabb[axes[name[5:]]] = float(value)
        else:
            raise KeyError(name)
        self.touch()

    def reset_model(self):
        """Reset button: fresh weights and occupancy state."""
        self.trainer.reset_model()
        self.touch()
        self.status = "model reset"
        return self.status

    def save_checkpoint(self):
        """Checkpoint button: a full checkpoint."""
        self.trainer.save_checkpoint(full=True)
        self.status = "checkpoint saved"
        return self.status

    def export_mesh(self):
        """Mesh button: Trainer.save_mesh at its defaults."""
        path = self.trainer.save_mesh()
        self.status = f"mesh saved: {path}"
        return self.status

    @property
    def _crop(self):
        return None if self.aabb == self._full_aabb else list(self.aabb)

    # ------------------------------------------------------------ loop steps
    def train_step(self):
        """One train chunk, then the next chunk's steps sized toward
        TRAIN_BUDGET_S (1 to 256)."""
        if not self.training or self.train_ds is None:
            return None
        out = self.trainer.train_gui(self.train_ds, step=self.train_steps)
        full_t = out["time"] / self.train_steps
        self.train_steps = int(np.clip(self.TRAIN_BUDGET_S / max(full_t, 1e-6), 1, 256))
        self._dirty = True
        return out

    def render_frame(self):
        """One pass; returns the (H, W, 3) frame so far. After a camera move
        (or a train chunk): the fast pass at `downscale`, which then moves
        toward RENDER_BUDGET_S by the square root of the time ratio (with
        dynamic resolution on). While idle: a refinement pass at twice the
        frame's resolution, up to full resolution, which replaces the frame
        (the render is deterministic, so averaging equal frames would do
        nothing); then Halton-jittered passes at full resolution averaged
        into it, one spp each, up to max_spp."""
        if self._dirty:
            self.spp = 0
            self._acc = None
            self._acc_scale = 0.0
            self._dirty = False
        if self.spp >= self.max_spp:
            return self._acc
        cam = self.cam
        if self._acc is None:
            out = self.trainer.test_gui(cam.pose, cam.intrinsics, cam.W, cam.H,
                                        bg_color=self.bg_color, downscale=self.downscale,
                                        crop_aabb=self._crop)
            self._acc_scale = self.downscale
            if self.dynamic_resolution:
                ratio = self.RENDER_BUDGET_S / max(out["time"], 1e-6)
                self.downscale = float(np.clip(self.downscale * np.sqrt(ratio), 0.25, 1.0))
            self._acc = out["image"]
            self.spp = 1
            return self._acc
        if self._acc_scale < 1.0:
            scale = min(1.0, self._acc_scale * 2.0)
            out = self.trainer.test_gui(cam.pose, cam.intrinsics, cam.W, cam.H,
                                        bg_color=self.bg_color, downscale=scale,
                                        crop_aabb=self._crop)
            self._acc = out["image"]
            self._acc_scale = scale
            self.spp = 1
            return self._acc
        out = self.trainer.test_gui(cam.pose, cam.intrinsics, cam.W, cam.H,
                                    bg_color=self.bg_color, downscale=1.0,
                                    crop_aabb=self._crop, pixel_offset=_halton_offset(self.spp))
        self._acc = (self._acc * self.spp + out["image"]) / (self.spp + 1)
        self.spp += 1
        return self._acc

    def touch(self):
        """Mark the view dirty (the camera moved or the model changed)."""
        self._dirty = True

    def _on_device(self):
        """A context that makes the Trainer's card the thread's current
        device: the server renders in each request's own thread."""
        if self._cuda is None:
            return contextlib.nullcontext()
        import torch

        return torch.cuda.device(self._cuda)

    # -------------------------------------------------------------- frontend
    def serve(self, host="127.0.0.1", port=7860, steps=None):
        """Serve the viewer at http://host:port (stdlib only). Drag orbits,
        shift-drag pans, the wheel zooms, 't' toggles training. `steps`
        bounds the requests served (None: until interrupted)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        gui = self
        lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE.encode())
                elif self.path.startswith("/frame"):
                    with lock, gui._on_device():
                        if gui.training:
                            gui.train_step()
                        jpg = encode_jpeg(gui.render_frame())
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.end_headers()
                    self.wfile.write(jpg)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                reply = b"{}"
                with lock, gui._on_device():
                    if self.path == "/orbit":
                        gui.cam.orbit(body.get("dx", 0), body.get("dy", 0))
                        gui.touch()
                    elif self.path == "/pan":
                        gui.cam.pan(body.get("dx", 0), body.get("dy", 0), body.get("dz", 0))
                        gui.touch()
                    elif self.path == "/zoom":
                        gui.cam.scale(body.get("delta", 0))
                        gui.touch()
                    elif self.path == "/train":
                        gui.training = not gui.training
                    elif self.path == "/set":
                        for k, v in body.items():
                            gui.set_option(k, v)
                    elif self.path == "/reset":
                        reply = json.dumps({"status": gui.reset_model()}).encode()
                    elif self.path == "/save_ckpt":
                        reply = json.dumps({"status": gui.save_checkpoint()}).encode()
                    elif self.path == "/save_mesh":
                        reply = json.dumps({"status": gui.export_mesh()}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(reply)

        server = ThreadingHTTPServer((host, port), Handler)
        print(f"[gui] serving viewer at http://{host}:{port}")
        try:
            if steps is None:
                server.serve_forever()
            else:
                for _ in range(steps):
                    server.handle_request()
        finally:
            server.server_close()


_PAGE = """<!doctype html><html><body style="margin:0;background:#111;color:#ccc;font:12px monospace">
<div style="display:flex">
<img id=v style="display:block;image-rendering:pixelated">
<div id=panel style="padding:8px;min-width:230px">
  <b>nerfnav_tpu_torch viewer</b><br>
  drag=orbit &middot; shift-drag=pan &middot; wheel=zoom &middot; t=train<br><br>
  <button onclick="post('/train',{})">start/stop training</button>
  <button onclick="act('/reset')">reset model</button><br>
  <button onclick="act('/save_ckpt')">save checkpoint</button>
  <button onclick="act('/save_mesh')">export mesh</button><br>
  <label><input id=dyn type=checkbox checked
    onchange="set('dynamic_resolution', this.checked)"> dynamic resolution</label><br>
  bg <input type=range min=0 max=1 step=0.05 value=1
    oninput="set('bg_color', +this.value)"><br>
  fovy <input type=range min=20 max=120 step=1 value=60
    oninput="set('fovy', +this.value)"><br>
  dt_gamma <input type=range min=0 max=0.1 step=0.002 value=0
    onchange="set('dt_gamma', +this.value)"><br>
  max spp <input type=range min=1 max=64 step=1 value=64
    oninput="set('max_spp', +this.value)"><br>
  <b>crop</b><br>
  <span id=crop></span>
  <div id=status></div>
</div></div>
<script>
const img = document.getElementById('v');
const post = (u, b) => fetch(u, {method:'POST', body:JSON.stringify(b)});
const set = (k, v) => post('/set', {[k]: v});
async function act(u){
  const r = await (await post(u, {})).json();
  document.getElementById('status').textContent = r.status || '';
}
// per-axis AABB crop sliders (reference gui.py:293-320)
const crop = document.getElementById('crop');
for(const ax of ['xmin','ymin','zmin','xmax','ymax','zmax']){
  const mn = ax.endsWith('min');
  crop.insertAdjacentHTML('beforeend',
    ax + ' <input type=range min=-2 max=2 step=0.05 value=' + (mn?-2:2) +
    ' oninput="set(\\'aabb_' + ax + '\\', +this.value)"><br>');
}
let dragging=false, lx=0, ly=0;
img.onmousedown = e => {dragging=true; lx=e.clientX; ly=e.clientY;};
window.onmouseup = () => dragging=false;
window.onmousemove = e => {
  if(!dragging) return;
  const d = {dx:e.clientX-lx, dy:e.clientY-ly};
  post(e.shiftKey ? '/pan' : '/orbit', d);
  lx=e.clientX; ly=e.clientY;
};
window.onwheel = e => post('/zoom', {delta:Math.sign(e.deltaY)});
window.onkeydown = e => {if(e.key=='t') post('/train', {})};
async function loop(){
  while(true){
    const r = await fetch('/frame?' + Date.now());
    img.src = URL.createObjectURL(await r.blob());
    await new Promise(r => setTimeout(r, 30));
  }
}
loop();
</script></body></html>"""
