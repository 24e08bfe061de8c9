"""The training executor and the train driver."""

from flexflow_tpu_torch.runtime.executor import Executor

__all__ = ["Executor"]
