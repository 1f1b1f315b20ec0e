from trident_tpu_torch.anim.data import Bone, Skeleton, AnimationClip, TransformChannel
from trident_tpu_torch.anim.player import AnimationPlayer
from trident_tpu_torch.anim.service import AnimationAssetService

__all__ = ["Bone", "Skeleton", "AnimationClip", "TransformChannel",
           "AnimationPlayer", "AnimationAssetService"]
