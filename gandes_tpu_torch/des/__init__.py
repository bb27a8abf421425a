from gandes_tpu_torch.des.engine import (
    Event,
    EventList,
    FlowBranchOperator,
    Queue,
    Server,
    Sim,
    SimBudgetExceeded,
    Source,
)
