from .adamw import AdamWState, OptConfig, adamw_init, adamw_update, lr_schedule

__all__ = ["AdamWState", "OptConfig", "adamw_init", "adamw_update", "lr_schedule"]
