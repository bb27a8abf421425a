from gandes_tpu_torch.core.rng import Sampler, spawn_node_seeds
from gandes_tpu_torch.core.eventlog import EventLog, LOG_PREFIX
