from nerfnav_tpu_torch.training.metrics import LPIPSMeter, PSNRMeter
from nerfnav_tpu_torch.training.trainer import Trainer, TrainerOptions, TrainState

__all__ = ["PSNRMeter", "LPIPSMeter", "Trainer", "TrainerOptions", "TrainState"]
