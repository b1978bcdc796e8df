"""The interactive viewer (gui/viewer.py): an orbit camera and the adaptive
train / render loop behind a stdlib web page."""

from nerfnav_tpu_torch.gui.viewer import NeRFGUI, OrbitCamera

__all__ = ["NeRFGUI", "OrbitCamera"]
