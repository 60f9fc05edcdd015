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

With no world size, ``init`` adopts the elastic mesh's survivor ranks after a
shrink (``elastic.py``); it joins the pod control plane when the Config names
a control world (``control/``).

With a ``coordinator_address``, ``num_processes`` and ``process_id``, the
world's virtual ranks are spread over that many processes, each holding its
own contiguous block (comm/mesh.py, comm/transport.py): ``init`` brings up
``torch.distributed`` once per process (NCCL on the card, gloo on the CPU,
``backend=`` to choose), with ``MLSL_DIST_INIT_RETRIES`` further attempts
``MLSL_DIST_INIT_BACKOFF_S * 2**(k-1)`` seconds apart, and ``finalize`` keeps
it up, as the JAX package keeps ``jax.distributed``. ``process_index`` and
``process_count`` name this process and the processes; ``get_process_count``
still counts virtual ranks. Without a coordinator no ``torch.distributed``
call is made.

``configure("color=...")`` restricts the world as the reference's
Configure does (src/mlsl.cpp:620-647): one value keeps every rank, one value a
rank keeps the ranks whose color equals the first one, so later
distributions span fewer virtual ranks. Across processes the K kept ranks
are laid over all P processes anew, K / P each (rank p of the restricted
world holds what the JAX package's p-th kept device holds), rather than kept
on the processes that held them (standing difference "the restricted world
relaid"); a K that does not split over the P processes raises MLSLError.
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

    def init(self, device=None, world_size: Optional[int] = None,
             coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
             process_id: Optional[int] = None, backend: Optional[str] = None) -> "Environment":
        """Bootstrap ``world_size`` virtual ranks on ``device``: 'cuda' (or
        'cuda:N') by default, 'cpu' only when asked for. With no
        ``world_size`` the world is the elastic registry's survivor ranks
        after a shrink (``elastic.active_devices()``, as the JAX package's
        init adopts the survivor devices), else 8. With a
        ``coordinator_address`` ('host:port'), the ranks are spread over
        ``num_processes`` processes, this one ``process_id``, over
        ``backend`` ('nccl' on the card, 'gloo' on the CPU by default)."""
        if self._initialized:
            return self
        if world_size is None:
            from mlsl_tpu_torch import elastic

            active = elastic.active_devices()
            world_size = len(active) if active is not None else 8
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
        from mlsl_tpu_torch.comm import transport
        from mlsl_tpu_torch.ops import cuda_build

        if coordinator_address is not None:
            mlsl_assert(num_processes is not None and process_id is not None,
                        "a coordinator_address needs num_processes and process_id")
            mlsl_assert(world_size % int(num_processes) == 0,
                        "%d virtual ranks do not split over %d processes", world_size,
                        int(num_processes))
            pre = Config.from_env()
            transport.bootstrap(coordinator_address, num_processes, process_id,
                                backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                max(0, pre.dist_init_retries),
                                max(0.0, pre.dist_init_backoff_s), dev)
        else:
            mlsl_assert(num_processes in (None, 1) and process_id in (None, 0)
                        and backend is None,
                        "num_processes, process_id and backend need a coordinator_address")
        transport.set_world_size(world_size)
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
        # the pod control plane (environment.py:134-144 of the JAX package):
        # a no-op unless the Config names a control world; it survives
        # rebuilds like the elastic registry
        from mlsl_tpu_torch import control

        control.ensure_started(config)
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
        from mlsl_tpu_torch.comm import mesh

        mesh._LOCALIZED.clear()
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

    def process_index(self) -> int:
        """This process's index among the processes (0 without a coordinator)."""
        from mlsl_tpu_torch.comm import transport

        return transport.world().index

    def process_count(self) -> int:
        """The number of processes the virtual ranks are spread over."""
        from mlsl_tpu_torch.comm import transport

        return transport.world().count

    def process_layout(self) -> tuple:
        """(process count, this process's index): what a Topology's boxes
        follow."""
        return self.process_count(), self.process_index()

    def configure(self, conf_str: str) -> None:
        """Color-based restriction of the world (reference Configure("color=N")).
        'color=N' keeps every rank; 'color=c0,c1,...' (one value a rank)
        keeps the ranks whose color equals the first listed color, so later
        distributions span that many virtual ranks. Across processes the
        kept ranks are relaid over every process (module docstring); the
        distributions made before keep the world they were made on."""
        conf_str = conf_str.strip()
        mlsl_assert(conf_str.startswith("color="), "unsupported configuration string: %s",
                    conf_str)
        values = [int(v) for v in conf_str.split("=", 1)[1].split(",")]
        if len(values) == 1:
            self._global_colors = tuple(values * self.world_size)
            return
        mlsl_assert(len(values) == self.world_size, "color list length %d != rank count %d",
                    len(values), self.world_size)
        kept = sum(1 for c in values if c == values[0])
        nproc = self.process_count()
        if nproc > 1 and kept != self.world_size:
            self._restrict_processes(kept, nproc, values[0])
        self._global_colors = tuple(values)
        self.world_size = kept

    def _restrict_processes(self, kept: int, nproc: int, color: int) -> None:
        """What ``init`` built from the world size follows the restricted
        world of ``kept`` ranks over ``nproc`` processes: the transport's
        world size (the boxes, the tiers, ``dcn_aware_devices``), and the
        tuned profile, kept only where its fingerprint matches the new world.
        The Dispatcher holds no world size. An uneven split, or a world the
        elastic registry shrank, raises MLSLError before anything changes."""
        from mlsl_tpu_torch import elastic, sysinfo
        from mlsl_tpu_torch.comm import transport

        if kept % nproc:
            raise MLSLError(f"configure('color=...') keeps {kept} ranks of color {color}, "
                            f"which do not split over {nproc} processes: {kept} virtual ranks "
                            f"over {nproc} processes needs a multiple of {nproc}")
        mlsl_assert(elastic.active_devices() is None,
                    "configure('color=...') on a world the elastic registry shrank: the "
                    "survivor ranks are not restricted across processes")
        transport.set_world_size(kept)
        profile = self.config.tuned_profile
        if profile is None:
            return
        try:
            same = profile.matches(sysinfo.topology_fingerprint(kept, self.device))
        except MLSLError:   # MLSL_MESH_TIERS does not cover the restricted world
            same = False
        if not same:
            from mlsl_tpu_torch.log import log_warning

            log_warning("tuner: the restricted world of %d ranks is not the one profile %r "
                        "was measured on; rejecting it", kept, profile.fingerprint)
            self.config.tuned_profile = None

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

