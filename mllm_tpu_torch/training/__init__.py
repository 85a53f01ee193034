from .lora import LoRALinear, add_lora, lora_params_filter, merge_lora
from .train import TrainState, make_train_step, restore_checkpoint, save_checkpoint

__all__ = [
    "TrainState", "make_train_step", "save_checkpoint", "restore_checkpoint",
    "LoRALinear", "add_lora", "merge_lora", "lora_params_filter",
]
