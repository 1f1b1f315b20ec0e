from trident_tpu_torch.assets.model_loader import ModelData, load_model
from trident_tpu_torch.assets.scene_loader import load_scene_directory

__all__ = ["ModelData", "load_model", "load_scene_directory"]
