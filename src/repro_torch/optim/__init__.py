"""Optimizers and schedules (port of ``repro.optim``).

Client optimizers (the paper's plain SGD) and server optimizers (FedAvg =
server-side SGD on the aggregated delta, optionally with momentum;
FedAdam/FedAdagrad, the adaptive variants of Reddi et al.).
"""

from .optimizers import Optimizer, adamw, fedadagrad, fedadam, fedavg, momentum, sgd
from .schedules import constant, cosine_decay, warmup_cosine

__all__ = [
    "Optimizer", "sgd", "momentum", "adamw",
    "fedavg", "fedadam", "fedadagrad",
    "constant", "cosine_decay", "warmup_cosine",
]
