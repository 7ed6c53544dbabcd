"""Shape and test helpers of the PyTorch port."""

from hpc_ops_tpu_torch.utils.common import cdiv, round_up

__all__ = ["cdiv", "round_up"]
