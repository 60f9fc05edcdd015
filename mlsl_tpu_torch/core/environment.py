"""The Environment singleton: bootstrap and global services.

Counterpart of ``mlsl_tpu.core.environment`` (reference include/mlsl.hpp:799-915,
src/mlsl.cpp:684-812). ``init`` builds no process world: it fixes the device
and the number of virtual ranks that live on it (see comm/mesh.py). The device
is CUDA unless the caller asks for the CPU explicitly; without CUDA, a default
``init()`` raises instead of falling back. As in the JAX package
(environment.py:80-114), ``init`` applies the log level and the device
class's defaults (``MLSL_AUTO_CONFIG_TYPE``), validates the configuration,
points the kernel builds at ``compile_cache_dir`` and then loads the tuned
profile, if one is named.

``configure("color=...")`` restricts the world as the reference's
Configure does (src/mlsl.cpp:620-647): one value keeps every rank, one value a
rank keeps the ranks whose color equals the first one, so later
distributions span fewer virtual ranks.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from mlsl_tpu_torch.comm.request import CommRequest, Dispatcher, RequestStorage
from mlsl_tpu_torch.config import Config
from mlsl_tpu_torch.log import MLSLError, mlsl_assert, set_log_level
from mlsl_tpu_torch.types import DataType, PhaseType, QuantParams, torch_dtype


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
        self.quant_params: Optional[QuantParams] = None
        self._distributions: list = []
        self._sessions: list = []
        self._global_colors: Optional[tuple] = None

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
            from mlsl_tpu_torch.ops import cpu_exp

            cpu_exp.warm(dev)   # before any CPU path's first exp (ROADMAP C.3)
        mlsl_assert(world_size >= 1, "world_size must be >= 1 (got %d)", world_size)
        from mlsl_tpu_torch import supervisor, sysinfo, tuner
        from mlsl_tpu_torch.ops import cuda_build

        # the JAX package's order (environment.py:80-86): the log level, the
        # device class's defaults (explicit exports win), then validation
        config = Config.from_env()
        set_log_level(config.log_level)
        sysinfo.auto_config(config, sysinfo.probe(dev.index) if dev.type == "cuda"
                            else sysinfo.SysInfo("cpu", "cpu", 0, (), 0))
        config.validate()
        # the breakers are process-wide and keep their state across a
        # rebuild, but adopt the validated thresholds
        supervisor.configure(config)
        # chaos_spec, trace*, lock_witness*, straggler_*, profile_on_trip
        supervisor.configure_fault_plane(config)
        # the kernels' build directory (compile_cache_dir) before the sweep,
        # which builds every kernel it times
        cuda_build.configure(config)

        tuner.init_profile(config, world_size, dev)
        self.config = config
        self.device = dev
        self.world_size = int(world_size)
        self.dispatcher = Dispatcher(self.config, device=dev)
        self._initialized = True
        # the telemetry plane (process-wide and idempotent, like the tracer):
        # the registry when MLSL_METRICS or a scrape port asks for it, and the
        # /metrics, /healthz and /statusz thread on MLSL_METRICS_PORT
        if config.metrics or config.metrics_port:
            from mlsl_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.enable(every=config.metrics_every,
                               retention=config.metrics_retention)
        if config.metrics_port:
            from mlsl_tpu_torch.obs import serve as obs_serve

            obs_serve.start_server(config.metrics_port)
        if self.quant_params is not None:
            # parameters set before init apply now that the config exists; a
            # codec that no longer loads unwinds init, so that a retry loads
            # it again instead of running the built-in codec
            try:
                self.set_quantization_params(self.quant_params)
            except Exception:
                supervisor.configure_fault_plane(None)
                cuda_build.configure(None)
                self._initialized = False
                self.dispatcher.shutdown()
                self.dispatcher = None
                self.config = None
                raise
        return self

    def finalize(self) -> None:
        if not self._initialized:
            return
        if self.dispatcher is not None:
            self.dispatcher.shutdown()
        for s in self._sessions:
            s._invalidate()
        self._sessions.clear()
        self._distributions.clear()
        # inline_allreduce's staged forms hold this world's member tables and
        # the kernel functions they were built with: none outlives the world
        from mlsl_tpu_torch.comm import algos

        algos._INLINE_PLANS.clear()
        # the fault plane's modules read their environment variables again
        from mlsl_tpu_torch import supervisor

        supervisor.configure_fault_plane(None)
        from mlsl_tpu_torch.ops import cuda_build

        cuda_build.configure(None)
        self._initialized = False
        Environment._instance = None

    def get_process_count(self) -> int:
        mlsl_assert(self._initialized, "Environment not initialized")
        return self.world_size

    def get_process_idx(self) -> int:
        """The single controller is logical rank 0; per-rank math lives on
        Distribution."""
        return 0

    def configure(self, conf_str: str) -> None:
        """Color-based restriction of the world (reference Configure("color=N")).
        'color=N' keeps every rank; 'color=c0,c1,...' (one value a rank)
        keeps the ranks whose color equals the first listed color, so later
        distributions span that many virtual ranks."""
        conf_str = conf_str.strip()
        mlsl_assert(conf_str.startswith("color="), "unsupported configuration string: %s",
                    conf_str)
        values = [int(v) for v in conf_str.split("=", 1)[1].split(",")]
        if len(values) == 1:
            self._global_colors = tuple(values * self.world_size)
            return
        mlsl_assert(len(values) == self.world_size, "color list length %d != rank count %d",
                    len(values), self.world_size)
        self._global_colors = tuple(values)
        self.world_size = sum(1 for c in values if c == values[0])

    def create_distribution(self, data_parts: int, model_parts: int, seq_parts: int = 1):
        from mlsl_tpu_torch.core.distribution import Distribution

        mlsl_assert(self._initialized, "Environment not initialized")
        d = Distribution(self, data_parts, model_parts, seq_parts=seq_parts)
        self._distributions.append(d)
        return d

    def create_distribution_with_colors(self, data_color_per_rank, model_color_per_rank):
        """A distribution whose data and model groups are color partitions of
        the world (reference CreateDistributionWithColors); the groups may be
        of unequal sizes."""
        from mlsl_tpu_torch.core.distribution import Distribution

        mlsl_assert(self._initialized, "Environment not initialized")
        d = Distribution(self, None, None, data_colors=tuple(data_color_per_rank),
                         model_colors=tuple(model_color_per_rank))
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
            session._invalidate()
            self._sessions.remove(session)

    # -- memory (reference Alloc/Free; buffers here are tensors) -------------

    def alloc(self, count: int, data_type: DataType = DataType.FLOAT) -> torch.Tensor:
        """A zeroed host buffer, for API parity: collectives take distributed
        tensors directly."""
        return torch.zeros((int(count),), dtype=torch_dtype(data_type))

    def free(self, buf) -> None:  # noqa: ARG002 - the collector owns the memory
        return None

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

    # -- quantization (reference src/mlsl.cpp:798) ------------------------

    def set_quantization_params(self, params: QuantParams) -> None:
        """Select the codec of QUANTIZATION collectives (reference
        src/mlsl.cpp:798 -> quant_load, quant/quant.c:96-133): callables
        register a user codec on torch tensors, ``lib_path`` loads a library
        of the reference's ABI (comm/codec.py; MLSLError when it cannot be
        honoured), and otherwise the built-in int8 codec runs; in every case
        ``elem_in_block`` becomes ``quant_block_elems``. State changes
        only once the codec has loaded and the block is valid, so a failed
        registration leaves the previous one in force. Before init the
        parameters are kept and applied at init, as in the reference."""
        from mlsl_tpu_torch.comm import codec as codec_mod

        codec = None
        if params.compress_fn is not None:
            mlsl_assert(params.decompress_fn is not None, "compress_fn requires decompress_fn")
            codec = codec_mod.CustomCodec(compress=params.compress_fn,
                                          decompress=params.decompress_fn,
                                          reduce=params.reduce_sum_fn)
        elif params.lib_path:
            codec = codec_mod.load_library_codec(params)   # MLSLError on failure
        if self.config is not None:
            old = self.config.quant_block_elems
            if params.elem_in_block:
                self.config.quant_block_elems = int(params.elem_in_block)
                try:
                    self.config.validate()
                except MLSLError:
                    self.config.quant_block_elems = old
                    raise
            self.config.custom_codec = codec
        self.quant_params = params

    def get_quantization_params(self) -> Optional[QuantParams]:
        return self.quant_params

    def get_version(self) -> str:
        from mlsl_tpu_torch import __version__

        return __version__

    # PascalCase parity aliases (reference include/mlsl.hpp:799-915)
    GetVersion = get_version
    Configure = configure
    CreateDistributionWithColors = create_distribution_with_colors
    Alloc = alloc
    Free = free
    SetQuantizationParams = set_quantization_params
    GetQuantizationParams = get_quantization_params
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

