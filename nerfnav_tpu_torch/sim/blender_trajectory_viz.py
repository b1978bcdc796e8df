"""Blender trajectory script: the planner's trajectories as curves in a scene.

Loads the planner's JSON artifacts (`<workspace>/{init,replan}_poses/<exp>/
*.json`, nav/planner.py) and builds one NURBS curve per file, through the
poses' positions, in a new collection, so the optimization history can be
inspected in the scene. Runs inside Blender's Python; bpy is imported in
main() only:

    blender scene.blend -P blender_trajectory_viz.py -- <workspace> <exp>
"""

import json
import os
import sys


def main():
    import bpy

    argv = sys.argv[sys.argv.index("--") + 1 :]
    workspace, exp = argv[0], argv[1]

    coll = bpy.data.collections.new(f"nav_trajectories_{exp}")
    bpy.context.scene.collection.children.link(coll)

    for kind in ("init", "replan"):
        d = os.path.join(workspace, f"{kind}_poses", exp)
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".json"):
                continue
            with open(os.path.join(d, fname)) as f:
                data = json.load(f)
            # the translation column of each 4x4 pose
            points = [[row[3] for row in pose][0:3] for pose in data["poses"]]
            if len(points) < 2:
                continue
            curve = bpy.data.curves.new(fname, type="CURVE")
            curve.dimensions = "3D"
            spline = curve.splines.new("NURBS")
            spline.points.add(len(points) - 1)
            for i, p in enumerate(points):
                spline.points[i].co = (p[0], p[1], p[2], 1.0)
            obj = bpy.data.objects.new(fname, curve)
            coll.objects.link(obj)


if __name__ == "__main__":
    main()
