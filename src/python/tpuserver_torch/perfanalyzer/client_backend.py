"""Backend-neutral client abstraction for the load managers.

Role of the reference's ``client_backend/`` layer
(client_backend.h:250-620): the load managers and profiler speak one
small interface, which :class:`InProcessBackend` maps onto
``tpuserver_torch.core.InferenceServer`` directly (the analogue of the
reference's Triton C-API backend: no sockets, so the client/transport
overhead is isolated from the model cost).

A backend hands out *prepared* requests (inputs built once, outside the
timed path), executes them synchronously (``infer``) or asynchronously
(``submit`` + completion callback — what the concurrency manager's
context free-list rides on), snapshots server statistics, and streams
generations token-by-token for the generation profiler.

The port's copy of the in-process half of ``perfanalyzer/
client_backend.py``: the socket backends (HTTP, gRPC, the replica pool)
are built on ``tritonclient``, which the port does not import, and stay
with the client-side ``tools/perf_analyzer.py``.  CUDA regions
(``tpuserver_torch.cuda_shared_memory``) take the place of XLA ones; on
a CUDA region the in-process resolve path hands the model a view of the
region's device memory, with no host copy.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class BackendError(Exception):
    """A request failed inside a backend (wraps the core's error)."""


def _coerce_int(value, default=0):
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


class ClientBackend:
    """The interface the load managers and profiler consume.

    ``capacity`` is the backend's true in-flight ceiling (executor
    threads).  Size it via ``max_inflight`` at construction: a load level
    above the capacity would silently measure the backend's own queueing,
    not the server.
    """

    kind = "?"
    supports_generation = False

    def __init__(self, max_inflight=None):
        self._executor = None
        self._executor_lock = threading.Lock()
        # an explicit bound is honored EXACTLY (a user capping
        # outstanding requests means it); only the unspecified case
        # gets the roomy default
        self._executor_workers = (max(1, int(max_inflight))
                                  if max_inflight else 64)
        self.capacity = self._executor_workers

    # -- metadata / statistics --------------------------------------------

    def model_metadata(self, model):
        raise NotImplementedError

    def model_config(self, model):
        raise NotImplementedError

    def server_statistics(self, model):
        """Cumulative stats dict ``{"model_stats": [...]}`` (KServe
        statistics extension shape)."""
        raise NotImplementedError

    def stats_snapshot(self, model):
        """Flat cumulative-counter snapshot for the profiler's window
        diffs (see :func:`tpuserver_torch.perfanalyzer.metrics.
        server_stats_snapshot`)."""
        from tpuserver_torch.perfanalyzer.metrics import (
            server_stats_snapshot,
        )

        return server_stats_snapshot(self.server_statistics(model), model)

    def prefix_cache_snapshot(self):
        """Cumulative radix prefix-cache counters ``{"hits": tokens,
        "misses": tokens}``, or None when the target has none."""
        return None

    def spec_snapshot(self):
        """Cumulative speculative-decoding counters ``{"steps": n,
        "proposed": tokens, "accepted": tokens}``, or None when the
        target has none."""
        return None

    # -- inference --------------------------------------------------------

    def prepare(self, model, input_sets):
        """Turn ``input_sets`` (list of name->np.ndarray dicts) into
        backend-native request handles.  Runs once per load level,
        OUTSIDE any measurement window — the timed path then only
        dispatches."""
        return [self._prepare_one(model, s) for s in input_sets]

    def _prepare_one(self, model, inputs):
        raise NotImplementedError

    def infer(self, prepared):
        """Synchronous inference of one prepared request; raises
        :class:`BackendError` on failure."""
        raise NotImplementedError

    def submit(self, prepared, on_done):
        """Non-blocking dispatch; ``on_done(error_or_None)`` fires on a
        completion thread.  Runs :meth:`infer` on a shared executor."""
        executor = self._ensure_executor()

        def run():
            try:
                self.infer(prepared)
            except Exception as e:  # noqa: BLE001 — handed to on_done
                on_done(e)
                return
            on_done(None)

        executor.submit(run)

    def _ensure_executor(self):
        if self._executor is None:
            with self._executor_lock:
                if self._executor is None:
                    self._executor = ThreadPoolExecutor(
                        max_workers=self._executor_workers,
                        thread_name_prefix="perfanalyzer-" + self.kind,
                    )
        return self._executor

    # -- generation (decoupled streaming) ---------------------------------

    def generate_stream(self, model, inputs, parameters=None, stats=None):
        """Generator yielding the token count of each streamed response
        as it arrives (1 for the llama TOKEN-per-response contract).
        The generation profiler timestamps each yield: first yield =
        TTFT, gaps = inter-token latencies.

        ``stats`` (optional dict) receives per-stream bookkeeping the
        profiler folds into its report (``stats["resumes"]`` for a
        backend that reconnects a dropped stream)."""
        raise NotImplementedError(
            "backend '{}' does not support generation mode".format(
                self.kind))

    def release_thread_resources(self):
        """Called by a generation worker as it exits; backends that pin
        per-thread resources free them here."""

    # -- shared-memory data plane -----------------------------------------

    def shm_register(self, name, kind, key=None, raw_handle=None,
                     byte_size=0, device_id=0):
        """Register a client-created region (``kind`` 'system' or
        'cuda') with the serving target."""
        raise NotImplementedError(
            "backend '{}' does not support shared memory".format(self.kind))

    def shm_unregister(self, name, kind):
        raise NotImplementedError(
            "backend '{}' does not support shared memory".format(self.kind))

    def prepare_shm(self, model, input_refs, output_refs=None):
        """Prepared requests whose inputs are :func:`shm_input_ref`
        descriptors (one dict per input set) and whose outputs land in
        shared memory (``output_refs``: list of ``(name, region,
        byte_size, offset)``), for :meth:`infer`/``submit``."""
        raise NotImplementedError(
            "backend '{}' does not support shared memory".format(self.kind))

    def close(self):
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None


def shm_input_ref(region, byte_size, offset, datatype, shape):
    """A shared-memory input reference: the value a prepared request
    carries instead of tensor bytes.  Understood by the backend's
    prepare and generate paths."""
    return {
        "shared_memory_region": region,
        "shared_memory_byte_size": int(byte_size),
        "shared_memory_offset": int(offset),
        "datatype": datatype,
        "shape": list(shape),
    }


def _is_shm_ref(value):
    return isinstance(value, dict) and "shared_memory_region" in value


def _response_token_count(outputs):
    """Tokens carried by one decoupled response, from its output list
    (dicts with name/shape).  Prefer a TOKEN/OUTPUT_IDS tensor's
    element count; fall back to 1 response = 1 step."""
    for entry in outputs or []:
        if entry.get("name") in ("TOKEN", "OUTPUT_IDS", "output_ids"):
            n = 1
            for d in entry.get("shape", []) or []:
                n *= max(1, _coerce_int(d, 1))
            data = entry.get("data")
            if isinstance(data, list) and data:
                n = len(data)
            return max(1, n)
    return 1


# -- in-process backend ----------------------------------------------------


class InProcessBackend(ClientBackend):
    """Drives ``tpuserver_torch.core.InferenceServer`` with no transport
    at all — the floor every socket client's overhead is measured
    against (the reference's C-API backend role)."""

    kind = "inprocess"
    supports_generation = True

    def __init__(self, core, max_inflight=None):
        super().__init__(max_inflight)
        self.core = core

    def model_metadata(self, model):
        return self.core.model_metadata(model)

    def model_config(self, model):
        return self.core.model_config(model)

    def server_statistics(self, model):
        return self.core.model_statistics(model)

    def _prepare_one(self, model, inputs):
        from tpuserver_torch.core import InferRequest

        return InferRequest(model, inputs=dict(inputs))

    def shm_register(self, name, kind, key=None, raw_handle=None,
                     byte_size=0, device_id=0):
        from tpuserver_torch.errors import TorchServeError

        try:
            if kind == "system":
                self.core.register_system_shm(name, key, 0, byte_size)
            else:
                self.core.register_cuda_shm(
                    name, raw_handle, device_id, byte_size)
        except TorchServeError as e:
            raise BackendError(str(e)) from e

    def shm_unregister(self, name, kind):
        from tpuserver_torch.errors import TorchServeError

        try:
            if kind == "system":
                self.core.unregister_system_shm(name)
            else:
                self.core.unregister_cuda_shm(name)
        except TorchServeError as e:
            raise BackendError(str(e)) from e

    def prepare_shm(self, model, input_refs, output_refs=None):
        return [("shm", model, dict(refs), list(output_refs or []))
                for refs in input_refs]

    def _resolve_refs(self, inputs):
        """Materialize shm references through the core's bounds-checked
        resolve path — for a CUDA region this returns a view of the
        region's device memory: the zero-copy plane.  Returns the inputs
        and the names of the regions they were read from."""
        out = {}
        regions = []
        for name, value in inputs.items():
            if _is_shm_ref(value):
                out[name] = self.core.read_shm_input(
                    value["shared_memory_region"],
                    value["shared_memory_byte_size"],
                    value.get("shared_memory_offset", 0),
                    value["datatype"],
                    value["shape"])
                regions.append(value["shared_memory_region"])
            else:
                out[name] = value
        return out, tuple(regions)

    def infer(self, prepared):
        """Run one prepared request; returns the core's
        ``InferResponse``."""
        from tpuserver_torch.core import InferRequest, RequestedOutput
        from tpuserver_torch.errors import TorchServeError

        try:
            if isinstance(prepared, tuple) and prepared[0] == "shm":
                _, model, refs, out_refs = prepared
                requested = None
                if out_refs:
                    requested = [
                        RequestedOutput(
                            n, binary_data=False, shm_region=region,
                            shm_byte_size=size, shm_offset=offset)
                        for n, region, size, offset in out_refs
                    ]
                inputs, regions = self._resolve_refs(refs)
                req = InferRequest(model, inputs=inputs,
                                   requested_outputs=requested)
                req.shm_input_regions = regions
                return self.core.infer(req)
            # a fresh request object per call: InferRequest carries
            # per-call deadline state the core stamps on it
            req = InferRequest(prepared.model_name,
                               inputs=prepared.inputs)
            return self.core.infer(req)
        except TorchServeError as e:
            raise BackendError(str(e)) from e

    def generate_stream(self, model, inputs, parameters=None, stats=None):
        from tpuserver_torch.core import InferRequest
        from tpuserver_torch.errors import TorchServeError

        try:
            resolved, regions = self._resolve_refs(inputs)
            req = InferRequest(model, inputs=resolved,
                               parameters=dict(parameters or {}))
            # the regions stay pinned while the stream lives, as the
            # front ends pin them
            req.shm_input_regions = regions
            for resp in self.core.infer_stream(req):
                yield _response_token_count(
                    [spec for spec, _ in resp.outputs])
        except TorchServeError as e:
            raise BackendError(str(e)) from e

    def _scheduler_stats(self):
        return [stats for stats in (self.core.health_snapshot().get("models")
                                    or {}).values()
                if isinstance(stats, dict)]

    def prefix_cache_snapshot(self):
        hits = misses = 0
        seen = False
        for stats in self._scheduler_stats():
            if "prefix_hits" in stats:
                seen = True
                hits += _coerce_int(stats.get("prefix_hits"))
                misses += _coerce_int(stats.get("prefix_misses"))
        return {"hits": hits, "misses": misses} if seen else None

    def spec_snapshot(self):
        steps = proposed = accepted = 0
        seen = False
        for stats in self._scheduler_stats():
            if "spec_steps" in stats:
                seen = True
                steps += _coerce_int(stats.get("spec_steps"))
                proposed += _coerce_int(stats.get("spec_proposed"))
                accepted += _coerce_int(stats.get("spec_accepted"))
        return ({"steps": steps, "proposed": proposed,
                 "accepted": accepted} if seen else None)


# -- shared-memory infer-data manager ---------------------------------------


class ShmInferDataManager:
    """Client-side shared-memory staging for one perf analyzer run (role
    of the reference's ``InferDataManagerShm``): every input set of the
    rotation pool is written ONCE into a created-and-registered region
    outside any measurement window; the prepared requests then carry
    ``{region, offset}`` references, so the timed path moves descriptors
    while the tensors ride the shm data plane.  ``kind='cuda'`` regions
    live in device memory on ``device`` (``"cpu"`` makes host regions an
    in-process core attaches, for tests): the in-process resolve path
    hands the model a view of them, with no host copy.

    Region names are namespaced by a ``tag`` (default: the pid plus a
    random suffix), so two runs against one server never collide;
    :meth:`close` unregisters and destroys every region this manager
    created.
    """

    def __init__(self, backend, kind, tag=None, device=None):
        if kind not in ("system", "cuda"):
            raise ValueError(
                "shared-memory kind must be 'system' or 'cuda' "
                "(got {!r})".format(kind))
        import os as _os
        import uuid as _uuid

        self.backend = backend
        self.kind = kind
        self.device = device
        self.tag = "{}_{}".format(
            tag if tag is not None else _os.getpid(),
            _uuid.uuid4().hex[:6])
        self._regions = []  # (name, handle)

    # -- region lifecycle --------------------------------------------------

    def create_region(self, label, byte_size):
        """Create + register one region; returns ``(name, handle)``.
        The handle stays client-owned (this side reads rings / output
        regions through it)."""
        name = "pa_{}_{}".format(self.tag, label)
        if self.kind == "system":
            from tpuserver_torch.perfanalyzer import (
                system_shared_memory as sysshm,
            )

            key = "/" + name
            handle = sysshm.create_shared_memory_region(
                name, key, byte_size)
            try:
                self.backend.shm_register(
                    name, "system", key=key, byte_size=byte_size)
            except Exception:
                sysshm.destroy_shared_memory_region(handle)
                raise
        else:
            from tpuserver_torch import cuda_shared_memory as csm

            handle = csm.create_shared_memory_region(
                name, byte_size, device=self.device)
            try:
                self.backend.shm_register(
                    name, "cuda", raw_handle=csm.get_raw_handle(handle),
                    byte_size=byte_size, device_id=handle.device_id)
            except Exception:
                csm.destroy_shared_memory_region(handle)
                raise
        self._regions.append((name, handle))
        return name, handle

    def write(self, handle, arrays, offset=0):
        """Stage arrays at ``offset`` (into device memory for a CUDA
        region, one copy each)."""
        if self.kind == "system":
            from tpuserver_torch.perfanalyzer import (
                system_shared_memory as sysshm,
            )

            sysshm.set_shared_memory_region(handle, arrays, offset=offset)
            return
        from tpuserver_torch import cuda_shared_memory as csm

        csm.set_shared_memory_region(handle, arrays, offset=offset)

    def read(self, handle, datatype, shape, offset=0):
        """A tensor of numpy ``datatype`` and ``shape`` read back to the
        host from a region this manager created (an output slot)."""
        if self.kind == "system":
            from tpuserver_torch.perfanalyzer import (
                system_shared_memory as sysshm,
            )

            return sysshm.get_contents_as_numpy(handle, datatype, shape,
                                                offset=offset)
        from tpuserver_torch import cuda_shared_memory as csm

        return csm.get_contents_as_numpy(handle, datatype, shape,
                                         offset=offset)

    def close(self):
        """Unregister (server side) and destroy (client side) every
        region this manager created."""
        regions, self._regions = self._regions, []
        for name, handle in regions:
            try:
                self.backend.shm_unregister(name, self.kind)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            try:
                if self.kind == "system":
                    from tpuserver_torch.perfanalyzer import (
                        system_shared_memory as sysshm,
                    )

                    sysshm.destroy_shared_memory_region(handle)
                else:
                    from tpuserver_torch import cuda_shared_memory as csm

                    csm.destroy_shared_memory_region(handle)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    # -- staging -----------------------------------------------------------

    def stage_input_sets(self, input_sets, datatypes=None):
        """Write the whole rotation pool into per-input regions (one
        region per input name, one slot per set) and return the
        reference dicts ``prepare_shm`` consumes — one per set.
        ``datatypes`` (name -> wire datatype, from the model's metadata)
        names each input's wire type; without it the array's dtype does,
        which cannot tell BF16 (``np.uint16`` bits) from UINT16."""
        from tpuserver_torch.tensor_io import wire_datatype

        sets = list(input_sets)
        if not sets:
            return []
        datatypes = datatypes or {}
        refs = [dict() for _ in sets]
        for name in sets[0]:
            arrays = [np.ascontiguousarray(s[name]) for s in sets]
            first = arrays[0]
            if first.dtype == np.object_:
                raise ValueError(
                    "shared-memory mode needs fixed-size dtypes; input "
                    "'{}' is BYTES".format(name))
            nbytes = first.nbytes
            if any(a.nbytes != nbytes for a in arrays):
                raise ValueError(
                    "input '{}': every pool set must share one shape "
                    "in shared-memory mode".format(name))
            label = "in_" + "".join(
                c for c in name.lower() if c.isalnum())[:24]
            region, handle = self.create_region(
                label, nbytes * len(arrays))
            datatype = datatypes.get(name) or wire_datatype(first)
            for i, a in enumerate(arrays):
                self.write(handle, [a], offset=i * nbytes)
                refs[i][name] = shm_input_ref(
                    region, nbytes, i * nbytes, datatype, a.shape)
        return refs

    def stage_outputs(self, output_names, byte_size):
        """One output region with a ``byte_size`` slot per declared
        output; returns the ``(name, region, byte_size, offset)`` list
        ``prepare_shm`` consumes."""
        names = list(output_names)
        if not names:
            return []
        region, _ = self.create_region("out", byte_size * len(names))
        return [
            (n, region, byte_size, j * byte_size)
            for j, n in enumerate(names)
        ]


# -- factory ---------------------------------------------------------------


def create_backend(kind, core=None, max_inflight=None):
    """Build a backend by name (the CLI's ``--backend`` flag): only
    ``inprocess``, which needs ``core`` (an ``InferenceServer``).
    ``max_inflight`` sizes the backend's executor so the requested load
    level actually reaches the server."""
    if kind == "inprocess":
        if core is None:
            raise ValueError("inprocess backend needs core=")
        return InProcessBackend(core, max_inflight=max_inflight)
    raise ValueError(
        "unknown backend '{}': the port's perf analyzer drives its core "
        "in-process only (want inprocess; measure over sockets with "
        "tools/perf_analyzer.py)".format(kind))


# -- input synthesis -------------------------------------------------------


def build_input_pool(metadata, config, pool_size=16, batch_size=1,
                     shape_overrides=None, const_overrides=None, seed=0):
    """A rotating pool of DISTINCT random input sets for one model.

    Measurement hygiene: every context rotates through distinct inputs
    so no (model, values) pair repeats back-to-back.  Shapes come from
    the model metadata; dynamic dims (-1) must be pinned via
    ``shape_overrides`` (name -> dims).  ``const_overrides`` (name ->
    scalar) fills an input with one fixed value instead of random data —
    for control inputs like a ``DELAY_US`` knob that must not be
    randomized.  Models with ``max_batch_size > 0`` get a leading
    ``batch_size`` axis, matching Triton config semantics.  BF16 inputs
    are ``np.uint16`` bits (the port's wire rule), bit for bit the JAX
    tool's ``bfloat16`` values for the same seed (both round float64 to
    float32, then to nearest even).
    """
    from tpuserver_torch.errors import BadRequest
    from tpuserver_torch.tensor_io import bf16_bits, wire_to_np_dtype

    def np_dtype_of(datatype):
        try:
            return wire_to_np_dtype(datatype)
        except BadRequest:
            return None

    shape_overrides = shape_overrides or {}
    const_overrides = const_overrides or {}
    batched = _coerce_int(config.get("max_batch_size", 0)) > 0
    pool = []
    for i in range(pool_size):
        rng = np.random.RandomState(seed + i)
        inputs = {}
        for spec in metadata.get("inputs", []):
            name = spec["name"]
            dims = list(shape_overrides.get(name, spec["shape"]))
            dims = [_coerce_int(d) for d in dims]
            if any(d < 1 for d in dims):
                raise ValueError(
                    "input '{}' has dynamic dims {}; pin them with "
                    "--shape {}:d1,d2,...".format(name, dims, name))
            if batched:
                dims = [batch_size] + dims
            datatype = spec["datatype"]
            if name in const_overrides:
                value = const_overrides[name]
                if datatype == "BYTES":
                    inputs[name] = np.full(dims, str(value).encode("utf-8"),
                                           dtype=np.object_)
                elif datatype == "BF16":
                    inputs[name] = np.full(dims, bf16_bits(np.float64(value)),
                                           dtype=np.uint16)
                else:
                    inputs[name] = np.full(dims, value,
                                           dtype=np_dtype_of(datatype))
            elif datatype == "BYTES":
                flat = np.array(
                    ["req{}-{}".format(i, j).encode("utf-8")
                     for j in range(int(np.prod(dims)))],
                    dtype=np.object_)
                inputs[name] = flat.reshape(dims)
            elif datatype == "BF16":
                inputs[name] = bf16_bits(rng.rand(*dims))
            else:
                np_dtype = np_dtype_of(datatype)
                if np_dtype is None:
                    raise ValueError(
                        "cannot synthesize datatype '{}' for input "
                        "'{}'".format(datatype, name))
                if np.issubdtype(np_dtype, np.integer):
                    inputs[name] = rng.randint(
                        0, 100, size=dims).astype(np_dtype)
                elif np_dtype == np.bool_:
                    inputs[name] = rng.randint(
                        0, 2, size=dims).astype(np.bool_)
                else:
                    inputs[name] = rng.rand(*dims).astype(np_dtype)
        pool.append(inputs)
    return pool
