"""Model zoo: the neural networks the framework trains and serves.

Port of trident_tpu/models/__init__.py: the frame-interpolation family
(the reference's only network, Scripts/train_frame_generator.py).
"""

from trident_tpu_torch.ai.model import InterpolationUNet, ResidualBlock, init_model
from trident_tpu_torch.ai.train import TrainConfig, create_state, train
from trident_tpu_torch.ai.validate import validate_checkpoint

__all__ = [
    "InterpolationUNet", "ResidualBlock", "init_model",
    "TrainConfig", "create_state", "train", "validate_checkpoint",
]
