"""PyTorch/CUDA port of ``distributed_training_tpu`` for NVIDIA Hopper.

Imports ``torch`` and numpy only: nothing of JAX and nothing of the JAX
package, which stays the reference this package is tested against.

    from distributed_training_tpu_torch import TrainConfig, Trainer
    Trainer(TrainConfig(...)).fit()          # on the card
    Trainer(TrainConfig(...), device="cpu")  # on the CPU, as the tests do
"""

from distributed_training_tpu_torch.config import TrainConfig
from distributed_training_tpu_torch.train.trainer import Trainer

__all__ = ["TrainConfig", "Trainer"]
