"""The navigation stack: planner, pose filter, agent and the fused MPC tick.

Counterpart of nerfnav_tpu/nav/. Import the submodules directly; the
matplotlib plots of nav/viz.py are ROADMAP A10's remainder.
"""
