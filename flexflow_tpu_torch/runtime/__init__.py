"""The training executor, the train driver, and the fault plan."""

from flexflow_tpu_torch.runtime.executor import Executor
from flexflow_tpu_torch.runtime.faults import FaultPlan, get_fault_plan, set_fault_plan

__all__ = ["Executor", "FaultPlan", "get_fault_plan", "set_fault_plan"]
