"""The navigation stack: planner, pose filter, agent and the fused MPC tick.

Counterpart of nerfnav_tpu/nav/. Import the submodules directly; nav/viz.py
holds the matplotlib plots.
"""
