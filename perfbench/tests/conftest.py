"""The benchmark's own tests: the harness, its readers and its references
on the CPU at tiny sizes. Tests marked `card` run a cell on a CUDA card and
skip without one; they decide inside the test, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


# tiny sizes of each cell for the CPU: the configurations' widths cut down
# and the occupancy grid kept at 128 (below that the program's block
# marcher groups its occupancy tests, which the reference's exact march
# does not do)
TINY = {
    "ngp-train-grid": {
        "config": {"flags": ["--ff", "--fp16", "--bound", "1", "--scale", "0.8", "--dt_gamma",
                             "0", "--grid_levels", "4", "--grid_hashmap_log2", "12",
                             "--grid_max_resolution", "64", "--num_rays", "256",
                             "--update_extra_interval", "4"],
                   "grid_levels": 4, "grid_log2_hashmap_size": 12, "grid_max_resolution": 64,
                   "num_rays": 256, "sigma_net": [8, 64, 16], "update_extra_interval": 4},
        # a sweep every 4 steps: the 16 full sweeps end at step 60, and the
        # later checked steps start at the first partial one
        "traffic": {"views": 4, "hw": 32, "scene_samples": 16, "warm_steps": 68,
                    "check_at": 64, "trace_after": 2, "trace_steps": 4}},
    "ngp-train-dense": {
        "config": {"flags": ["--ff", "--fp16", "--bound", "1", "--scale", "0.8", "--dt_gamma",
                             "0", "--grid_levels", "4", "--grid_hashmap_log2", "12",
                             "--grid_max_resolution", "64", "--num_rays", "256",
                             "--num_steps", "32"],
                   "grid_levels": 4, "grid_log2_hashmap_size": 12, "grid_max_resolution": 64,
                   "num_rays": 256, "num_steps": 32, "sigma_net": [8, 64, 16]},
        "traffic": {"views": 4, "hw": 32, "scene_samples": 16, "warm_steps": 4,
                    "trace_after": 1, "trace_steps": 2}},
}


@pytest.fixture
def tiny():
    return TINY
