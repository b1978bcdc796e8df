"""Headless Blender render script: the Blender half of the nav agent's
observation file RPC (nav/agent.py `Agent._get_img_blender`).

Reads the JSON request {pose: 4x4 camera-to-world in Blender's convention,
res_x, res_y, trans, mode}, points the scene camera (made if the scene has
none) there and renders a PNG to the path given. Runs inside Blender's
Python; bpy and mathutils are imported in main() only:

    blender -b scene.blend -P blender_render.py -- pose.json out.png
"""

import json
import sys


def main():
    import bpy
    from mathutils import Matrix

    argv = sys.argv[sys.argv.index("--") + 1 :]
    pose_path, img_path = argv[0], argv[1]
    with open(pose_path) as f:
        req = json.load(f)

    scene = bpy.context.scene
    cam = scene.camera
    if cam is None:
        cam_data = bpy.data.cameras.new("nav_cam")
        cam = bpy.data.objects.new("nav_cam", cam_data)
        scene.collection.objects.link(cam)
        scene.camera = cam

    cam.matrix_world = Matrix(req["pose"])
    scene.render.resolution_x = int(req.get("res_x", 800))
    scene.render.resolution_y = int(req.get("res_y", 800))
    scene.render.film_transparent = bool(req.get("trans", True))
    scene.render.image_settings.color_mode = req.get("mode", "RGBA")
    scene.render.image_settings.file_format = "PNG"
    scene.render.filepath = img_path
    bpy.ops.render.render(write_still=True)


if __name__ == "__main__":
    main()
