"""The Environment singleton: bootstrap and global services.

Counterpart of ``mlsl_tpu.core.environment`` (reference include/mlsl.hpp:799-915,
src/mlsl.cpp:684-812). ``init`` builds no process world: it fixes the device
and the number of virtual ranks that live on it (see comm/mesh.py). The device
is CUDA unless the caller asks for the CPU explicitly; without CUDA, a default
``init()`` raises instead of falling back. As in the JAX package
(environment.py:114), ``init`` validates the configuration and then loads the
tuned profile, if one is named.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from mlsl_tpu_torch.comm.request import CommRequest, Dispatcher, RequestStorage
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.log import MLSLError, mlsl_assert
from mlsl_tpu_torch.types import PhaseType


class Environment:
    """Process-wide singleton (reference include/mlsl.hpp:799)."""

    _instance: Optional["Environment"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._initialized = False
        self.config: Optional[Config] = None
        self.dispatcher: Optional[Dispatcher] = None
        self.request_storage = RequestStorage()
        self.device: Optional[torch.device] = None
        self.world_size = 0
        self._distributions: list = []
        self._sessions: list = []

    @classmethod
    def get_env(cls) -> "Environment":
        with cls._lock:
            if cls._instance is None:
                cls._instance = Environment()
            return cls._instance

    @classmethod
    def is_initialized(cls) -> bool:
        return cls._instance is not None and cls._instance._initialized

    def init(self, device=None, world_size: int = 8) -> "Environment":
        """Bootstrap ``world_size`` virtual ranks on ``device``: 'cuda' (or
        'cuda:N') by default, 'cpu' only when asked for."""
        if self._initialized:
            return self
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise MLSLError(
                    "CUDA is not available: Environment.init() runs on the card; "
                    "pass device='cpu' explicitly to run on the CPU"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        else:
            mlsl_assert(dev.type == "cpu", "unsupported device %s", dev)
        mlsl_assert(world_size >= 1, "world_size must be >= 1 (got %d)", world_size)
        config = Config.from_env()
        config.validate()
        from mlsl_tpu_torch import tuner

        tuner.init_profile(config, world_size, dev)
        self.config = config
        self.device = dev
        self.world_size = int(world_size)
        self.dispatcher = Dispatcher(self.config)
        self._initialized = True
        return self

    def finalize(self) -> None:
        if not self._initialized:
            return
        if self.dispatcher is not None:
            self.dispatcher.shutdown()
        self._sessions.clear()
        self._distributions.clear()
        self._initialized = False
        Environment._instance = None

    def get_process_count(self) -> int:
        mlsl_assert(self._initialized, "Environment not initialized")
        return self.world_size

    def get_process_idx(self) -> int:
        """The single controller is logical rank 0; per-rank math lives on
        Distribution."""
        return 0

    def create_distribution(self, data_parts: int, model_parts: int, seq_parts: int = 1):
        from mlsl_tpu_torch.core.distribution import Distribution

        mlsl_assert(self._initialized, "Environment not initialized")
        d = Distribution(self, data_parts, model_parts, seq_parts=seq_parts)
        self._distributions.append(d)
        return d

    def delete_distribution(self, dist) -> None:
        if dist in self._distributions:
            self._distributions.remove(dist)

    def create_session(self, phase_type=None):
        from mlsl_tpu_torch.core.session import Session

        mlsl_assert(self._initialized, "Environment not initialized")
        s = Session(self, phase_type if phase_type is not None else PhaseType.TRAIN)
        self._sessions.append(s)
        return s

    def delete_session(self, session) -> None:
        if session in self._sessions:
            self._sessions.remove(session)

    # -- generic request completion (reference src/mlsl.cpp:784-796) ------

    def wait(self, req: CommRequest):
        out = req.wait()
        self.request_storage.remove(req)
        return out

    def test(self, req: CommRequest):
        done, out = req.test()
        if done:
            self.request_storage.remove(req)
        return done, out

    # PascalCase parity aliases (reference include/mlsl.hpp:799-915)
    GetEnv = get_env
    Init = init
    Finalize = finalize
    GetProcessCount = get_process_count
    GetProcessIdx = get_process_idx
    CreateDistribution = create_distribution
    DeleteDistribution = delete_distribution
    CreateSession = create_session
    DeleteSession = delete_session
    Wait = wait
    Test = test


def get_env() -> Environment:
    return Environment.get_env()


def default_device() -> torch.device:
    """Where a model's parameters go unless the caller says: the initialised
    Environment's device, else the current CUDA card. Never the CPU by
    default; ``device="cpu"`` must be asked for."""
    env = Environment._instance
    if env is not None and env._initialized:
        return env.device
    return torch.device("cuda")

