"""Scripts that run inside Blender's Python (bpy), not in this package's
process: blender_render.py answers the nav agent's observation requests,
blender_trajectory_viz.py draws the planner's trajectories in a scene."""
