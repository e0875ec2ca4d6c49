"""SpmmPlan and StreamingPlan: prepare an SpMM once, run it many times.

    >>> import repro_torch.sparse_api as sp
    >>> P = sp.plan(A, n=64)                       # resolve and prepare ONCE
    >>> y = P.run(b, c, alpha=2.0, beta=0.5)       # hot loop

A resident plan (:class:`SpmmPlan`) resolves the backend (``auto``
included), commits A's payload to the plan's device and, for the flat
path, precomputes the gather/scatter ids. ``run`` is bit-identical to the
unplanned ``spmm`` on the same backend: it runs the same code on the same
operands. ``run(values=)`` substitutes a new non-zero payload of A's
structure.

A streaming plan (:class:`StreamingPlan`, chosen by
``plan(..., device_bytes=)`` when the resident working set exceeds the
budget, or forced by ``stream=True``) is the out-of-core tier. The payload
stays in host memory. A run walks a 2-D (N-tile x K-window-chunk) grid:
each step stages one ``(MB, WCHUNK, LW)`` slab chunk and the matching
``(WCHUNK*K0, NTILE)`` block of ``b`` into device memory and adds it onto
a carried f32 accumulator through the backend's stream hook (the kernels'
accumulate mode); the epilogue is applied once per tile. Results are
bit-identical to the resident path (see ``backends.StreamOps``).

Plans are a forward construct: training goes through ``spmm`` or
``spmm_streaming``. Unlike the reference, which compiles each plan's
executables ahead of time, the port runs eagerly, so it keeps no
executable cache and no exec-cache counters; ``mesh=``, ``autotune=`` and
``plan_group`` belong to later slices.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.partition import cdiv

from . import backends as _bk
from .ops import as_dense
from .tensor import _SLAB_FIELDS, Format, PackedSpMM, SparseTensor, _device

__all__ = ["SpmmPlan", "StreamingPlan", "plan", "device_memory_budget",
           "PLAN_STATS"]

# Plan dispatches (one per resident run; per streamed run, one per window
# step plus one epilogue per column tile) and the streaming tier's window
# steps, counted as the reference counts them.
PLAN_STATS: Dict[str, int] = {"dispatches": 0, "window_dispatches": 0}

_AB_CACHE_MAX = 256


def device_memory_budget() -> Optional[int]:
    """The bytes free on the current CUDA device now: the first figure of
    ``torch.cuda.mem_get_info()`` (free, not total). ``None`` without a
    card, so ``plan(..., device="cpu", device_bytes="auto")`` stays
    resident, as the reference's plan does on a backend that reports no
    limit."""
    if not torch.cuda.is_available():
        return None
    free, _total = torch.cuda.mem_get_info()
    return int(free)


def _per_window_bytes(d, n: int, itemsize: int) -> int:
    """Device bytes one K0 window adds to a streamed chunk, by the
    reference's formula: the vals/cols/rows slab columns (4 B each), its
    ``q`` column, the staged ``(K0, N)`` rows of ``b`` plus one in-step
    copy of them, and an ``(MB*LW, N)`` f32 per-slot contribution
    intermediate. The CUDA kernels never allocate that intermediate; it is
    kept so that the port picks the reference's tiling for the same
    budget."""
    return (d.mb * d.lw * 12 + d.mb * 4
            + 2 * d.k0 * n * itemsize
            + d.mb * d.lw * n * 4)


def _ab_operands(cache: Dict, alpha, beta, device) -> Tuple[Any, Any]:
    """alpha and beta as 0-d f32 tensors on ``device``, cached per value so
    that a hot loop writes no scalar to the device again; tensors convert
    directly."""
    def shaped(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.full((), float(x), dtype=torch.float32, device=device)

    if isinstance(alpha, torch.Tensor) or isinstance(beta, torch.Tensor):
        return shaped(alpha), shaped(beta)
    key = (float(alpha), float(beta))
    hit = cache.get(key)
    if hit is None:
        hit = (shaped(alpha), shaped(beta))
        if len(cache) < _AB_CACHE_MAX:
            cache[key] = hit
    return hit


def _check_tensor(a) -> None:
    if not isinstance(a, SparseTensor):
        raise TypeError(f"plan expects a SparseTensor, got {type(a).__name__}")
    if a.format is not Format.HFLEX:
        raise ValueError(f"unsupported format {a.format}")


class SpmmPlan:
    """A prepared ``C = alpha * A @ B + beta * C`` for one (A, N) pair on
    one device. Build it with :func:`plan`.

    ``backend`` is the resolved backend name (never ``"auto"``); ``device``
    the device it computes on, where A's payload now lies.
    """

    def __init__(self, a: SparseTensor, n: int, backend: str,
                 opts: Dict[str, Any], dtype=torch.float32, device=None):
        _check_tensor(a)
        if n <= 0:
            raise ValueError("n must be positive")
        self.device = _device(a.device if device is None else device)
        self.a = a = a.to_device(self.device)
        self.n = int(n)
        self.m, self.k = a.shape
        self.backend = _bk.resolve_backend(backend, a, n=self.n,
                                           platform=self.device.type)
        self.opts = dict(opts)
        self.dtype = dtype
        self._fn = _bk.get_backend(self.backend).fn
        # The flat path's gather/scatter ids are derived once here, by the
        # same helper the unplanned backend uses on every call.
        self._flat = self._fn is _bk._backend_torch
        self._ids = _bk._hflex_global_ids(a.data) if self._flat else None
        self._zero_c: Optional[torch.Tensor] = None
        self._ab_cache: Dict[Tuple[float, float], Tuple[Any, Any]] = {}

    @property
    def payload_bytes(self) -> int:
        """Bytes of the operands this plan keeps on its device between
        runs: A's payload, plus the flat path's precomputed ids."""
        extra = 0
        if self._ids is not None:
            extra = sum(x.numel() * x.element_size() for x in self._ids)
        return self.a.nbytes + extra

    def run(self, b, c=None, alpha=1.0, beta=0.0, *, values=None
            ) -> torch.Tensor:
        """One planned SpMM. ``b`` is ``(K, N)`` of the planned dtype;
        ``c`` defaults to zeros; ``values`` substitutes a non-zero payload
        of A's packed shape."""
        b = as_dense(b, self.device)
        if tuple(b.shape) != (self.k, self.n) or b.dtype != self.dtype:
            raise ValueError(
                f"plan expects b of shape {(self.k, self.n)} dtype "
                f"{self.dtype}, got {tuple(b.shape)} {b.dtype}")
        if c is None:
            if self._zero_c is None:
                self._zero_c = torch.zeros((self.m, self.n), dtype=self.dtype,
                                           device=self.device)
            c = self._zero_c
        else:
            c = as_dense(c, self.device).to(self.dtype)
            if tuple(c.shape) != (self.m, self.n):
                raise ValueError(f"c must have shape {(self.m, self.n)}, got "
                                 f"{tuple(c.shape)}")
        alpha, beta = _ab_operands(self._ab_cache, alpha, beta, self.device)
        a = self.a
        if values is not None:
            a = a.with_values(as_dense(values, self.device))
        PLAN_STATS["dispatches"] += 1
        with torch.no_grad():
            if self._flat:
                live, rows_g, cols_g = self._ids
                return _bk._hflex_flat_exec(a.values[live], cols_g, rows_g, b,
                                            c, alpha, beta, self.m)
            return self._fn(a, b, c, alpha, beta, **self.opts)

    def __call__(self, b, c=None, alpha=1.0, beta=0.0, **kw):
        return self.run(b, c, alpha, beta, **kw)

    def __repr__(self) -> str:
        return (f"SpmmPlan(shape=({self.m}, {self.k})@{self.n}, "
                f"backend={self.backend!r}, device={self.device})")


class _Staging:
    """Double-buffered staging of window chunks into the compute device.

    On a card each of the two slots is a set of pinned host tensors and a
    set of device tensors of one chunk's shape. A chunk is written into a
    slot's pinned tensors (contiguous, by the host), then copied to the
    slot's device tensors on a side stream, asynchronously. Two events
    guard each slot: ``copied`` (the copy has finished: the compute stream
    waits on it before the step, and the host before it rewrites the
    pinned tensors) and ``freed`` (the step that read the slot has
    finished: the copy stream waits on it before it overwrites the device
    tensors). The device tensors are allocated once, on the compute
    stream, and live as long as the plan, so no tensor allocated on the
    copy stream is ever used on the compute stream. Pinned memory matters:
    from pageable or non-contiguous host memory ``non_blocking=True``
    copies synchronously, without a warning. On the CPU a slot's tensors
    are the chunk itself and nothing is copied.
    """

    def __init__(self, shapes: Dict[str, Tuple[Tuple[int, ...], Any]],
                 device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = [{f: torch.empty(s, dtype=dt, pin_memory=self.cuda)
                      for f, (s, dt) in shapes.items()} for _ in range(2)]
        self.dev = ([{f: torch.empty(s, dtype=dt, device=device)
                      for f, (s, dt) in shapes.items()} for _ in range(2)]
                    if self.cuda else self.host)
        self.nbytes = sum(x.numel() * x.element_size()
                          for x in self.host[0].values())
        self.copied = [None, None]
        self.freed = [None, None]
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.d2h_stream: Optional[torch.cuda.Stream] = None

    def stage(self, slot: int, fill) -> None:
        """Write a chunk into ``slot`` with ``fill(host_tensors)`` and start
        its copy to the device."""
        if not self.cuda:
            fill(self.host[slot])
            return
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()       # pinned tensors free again
        fill(self.host[slot])
        with torch.cuda.stream(self.copy_stream):
            if self.freed[slot] is not None:
                self.copy_stream.wait_event(self.freed[slot])
            for f, x in self.dev[slot].items():
                x.copy_(self.host[slot][f], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.copy_stream)
            self.copied[slot] = ev

    def acquire(self, slot: int) -> Dict[str, torch.Tensor]:
        """The slot's device tensors, once the compute stream has waited
        for their copy."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self.copied[slot])
        return self.dev[slot]

    def release(self, slot: int) -> None:
        """Mark the slot free once the work queued so far on the compute
        stream has finished."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.freed[slot] = ev

    def start_to_host(self, x: torch.Tensor):
        """Start copying ``x`` to pinned host memory on a stream of its
        own, after the work queued so far on the compute stream, and return
        at once. The copy overlaps both the steps queued after it and the
        staging copies. Hand the returned handle to :meth:`land`."""
        if not self.cuda:
            return x, None, None
        if self.d2h_stream is None:
            self.d2h_stream = torch.cuda.Stream(self.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.d2h_stream):
            self.d2h_stream.wait_event(ready)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.d2h_stream)
        # ``x`` stays referenced in the handle until the copy has landed,
        # so the allocator cannot hand its memory out before then.
        return host, done, x

    @staticmethod
    def land(handle) -> torch.Tensor:
        """Wait for a copy started by :meth:`start_to_host`; its host
        tensor."""
        host, done, _x = handle
        if done is not None:
            done.synchronize()
        return host


class StreamingPlan:
    """Out-of-core SpMM: window chunks stream from host memory through a
    carried f32 accumulator on the compute device. Build it with
    ``plan(..., device_bytes=)`` or ``plan(..., stream=True)``.

    The payload is held on the host (a host-packed A is used as it is; a
    device-packed one is copied off). A run walks column tiles outer and
    window chunks inner: ``steps = ceil(NW / window_chunk)`` steps per
    tile, each adding one ``(MB, WCHUNK, LW)`` chunk and the matching
    ``(WCHUNK*K0, NTILE)`` block of ``b``, staged through double-buffered
    pinned memory while the previous step computes. The tail chunk is
    padded with inert windows (``q`` = ``nse`` = 0, rows past ``MB*TM``)
    and the tail tile with zero columns. The epilogue runs once per tile.
    ``run`` waits for the device only to reuse a staging slot, and, with
    ``n_tiles > 1``, for a finished stripe's copy to the host: the copy
    starts as soon as the stripe is made, runs on its own stream while the
    next tile computes, and is waited for one tile later, so that at most
    two stripes lie on the card.

    The budget sizes both dimensions as the reference does: the largest
    ``n_tile`` (N, then descending powers of two) whose working set
    ``2*WCHUNK*per_window(NTILE) + acc(NTILE) + 2*M*NTILE*itemsize``
    admits at least one window per step wins, and ``window_chunk`` is the
    largest power of two that fits. With ``n_tiles == 1`` the result lies
    on the compute device; with ``n_tiles > 1`` it is a CPU tensor (the
    whole C is what the budget said does not fit).

    Attributes: ``window_chunk``, ``n_tile``, ``n_tiles``, ``steps``,
    ``window_dispatches`` (steps per run), ``payload_bytes`` (the host
    payload), ``chunk_payload_bytes`` and ``peak_payload_bytes`` (the
    reference's device working-set estimate), ``h2d_bytes`` (bytes staged
    into the device per run).
    """

    def __init__(self, a: SparseTensor, n: int, backend: str,
                 opts: Dict[str, Any], dtype=torch.float32, device="cuda",
                 device_bytes: Optional[int] = None,
                 window_chunk: Optional[int] = None,
                 n_tile: Optional[int] = None):
        _check_tensor(a)
        if n <= 0:
            raise ValueError("n must be positive")
        self.device = _device(device)
        self.n = int(n)
        self.m, self.k = a.shape
        self.backend = _bk.resolve_backend(backend, a, n=self.n,
                                           platform=self.device.type)
        stream = _bk.get_backend(self.backend).stream
        if stream is None:
            raise ValueError(
                f"backend {self.backend!r} has no streaming hooks "
                f"(StreamOps); register it with stream= to use it out of "
                f"core")
        self._stream = stream
        self.opts = dict(opts)
        self.dtype = dtype
        self.device_bytes = device_bytes
        # The payload lives on the host; the plan keeps no device copy.
        host = {f: getattr(a.data, f).cpu() for f in _SLAB_FIELDS}
        self.a = SparseTensor(data=dataclasses.replace(a.data, **host),
                              format=a.format, shape=a.shape)
        d = self._d = self.a.data

        if window_chunk is not None:
            window_chunk = int(window_chunk)
            if not 1 <= window_chunk <= d.nw:
                raise ValueError(
                    f"window_chunk must be in [1, NW={d.nw}], got "
                    f"{window_chunk}")
        if n_tile is not None:
            n_tile = int(n_tile)
            if not 1 <= n_tile <= self.n:
                raise ValueError(
                    f"n_tile must be in [1, N={self.n}], got {n_tile}")
        ntile, wc = self._choose_tiling(device_bytes, n_tile, window_chunk)
        self.n_tile = ntile
        self.n_tiles = cdiv(self.n, ntile)
        self.window_chunk = wc
        self.steps = cdiv(d.nw, wc)
        acc_bytes = self._acc_bytes(ntile)
        out_bytes = 2 * self.m * ntile * dtype.itemsize   # c + out stripe
        self.chunk_payload_bytes = wc * _per_window_bytes(d, ntile,
                                                          dtype.itemsize)
        self.peak_payload_bytes = (2 * self.chunk_payload_bytes
                                   + acc_bytes + out_bytes)
        if (device_bytes is not None
                and self.peak_payload_bytes > device_bytes):
            warnings.warn(
                f"streaming working set ({self.peak_payload_bytes} B: "
                f"2x{self.chunk_payload_bytes} B chunks + {acc_bytes} B "
                f"accumulator + {out_bytes} B epilogue operands) exceeds "
                f"device_bytes={device_bytes}; window_chunk="
                f"{self.window_chunk} is already the floor for this "
                f"(M, N) even with N-tiling — raise the budget or shrink "
                f"M",
                stacklevel=3)
        kc = wc * d.k0
        self._shapes = dict(
            vals=((d.mb, wc, d.lw), torch.float32),
            cols=((d.mb, wc, d.lw), torch.int32),
            rows=((d.mb, wc, d.lw), torch.int32),
            q=((d.mb, wc), torch.int32),
            nse=((d.mb, wc), torch.int32),
            b=((kc, ntile), dtype))
        self._staging: Optional[_Staging] = None
        self._zero_c: Optional[torch.Tensor] = None
        self._ab_cache: Dict[Tuple[float, float], Tuple[Any, Any]] = {}

    # -- sizing --------------------------------------------------------------

    def _acc_bytes(self, width: int) -> int:
        """Bytes of the accumulator the backend's ``init`` allocates for a
        dense width (kernel layouts pad it up), shaped on the meta device."""
        acc = self._stream.init(self.a, width, device="meta", **self.opts)
        return acc.numel() * 4

    def _choose_tiling(self, device_bytes, n_tile, window_chunk):
        """The (n_tile, window_chunk) grid for the budget, as the reference
        picks it (see the class docstring). Explicit values pin their
        dimension; no budget means (N, 1); if nothing fits, the requested
        width at one window (the caller warns)."""
        d = self._d
        itemsize = self.dtype.itemsize
        if device_bytes is None:
            return (n_tile or self.n), (window_chunk or 1)
        budget = int(device_bytes)
        if n_tile is not None:
            candidates = [n_tile]
        else:
            candidates = [self.n]
            t = 1
            while t < self.n:
                t <<= 1
            t >>= 1                                  # largest pow2 < N
            while t >= 1:
                candidates.append(t)
                t >>= 1
        for ntile in candidates:
            acc_bytes = self._acc_bytes(ntile)
            out_bytes = 2 * self.m * ntile * itemsize
            per_w = _per_window_bytes(d, ntile, itemsize)
            if window_chunk is not None:
                if (2 * window_chunk * per_w + acc_bytes + out_bytes
                        <= budget):
                    return ntile, window_chunk
                continue
            avail = max(budget - acc_bytes - out_bytes, 0) // 2
            wc = avail // per_w
            if wc >= 1:
                wc = 1 << (int(wc).bit_length() - 1)  # pow2 bucket
                return ntile, min(wc, d.nw)
        return (n_tile or self.n), (window_chunk or 1)

    @property
    def payload_bytes(self) -> int:
        """Full packed payload bytes, held on the host."""
        return self.a.nbytes

    @property
    def window_dispatches(self) -> int:
        """Window steps per run (``steps`` per column tile)."""
        return self.steps * self.n_tiles

    @property
    def h2d_bytes(self) -> int:
        """Bytes staged into the compute device per run: one chunk's slabs,
        ``q``, ``nse`` and block of ``b`` per window step (``c`` tiles
        not counted)."""
        per_step = sum(
            torch.Size(s).numel() * dt.itemsize
            for s, dt in self._shapes.values())
        return per_step * self.window_dispatches

    # -- execution -----------------------------------------------------------

    def _fill_chunk(self, dst: Dict[str, torch.Tensor], i: int, n0: int,
                    b_h: torch.Tensor, vals_h: torch.Tensor) -> None:
        """Write chunk ``i`` of column tile ``[n0, n0 + n_tile)`` into the
        host tensors ``dst`` (of the staging shapes), padding the tail
        chunk with inert windows and the tail tile with zero columns."""
        d = self._d
        wc, k0 = self.window_chunk, d.k0
        w0 = i * wc
        w1 = min(d.nw, w0 + wc)
        nwin = w1 - w0
        srcs = dict(vals=vals_h, cols=d.cols, rows=d.rows, q=d.q, nse=d.nse)
        # Inert windows: q = nse = 0, so no step walks or gathers them, and
        # rows = MB*TM maps their slots past every output row in both row
        # layouts.
        pads = dict(vals=0, cols=0, rows=d.mb * d.tm, q=0, nse=0)
        for f, src in srcs.items():
            dst[f][:, :nwin].copy_(src[:, w0:w1])
            if nwin < wc:
                dst[f][:, nwin:].fill_(pads[f])
        kb0 = w0 * k0
        kb1 = min(self.k, kb0 + wc * k0)
        n1 = min(self.n, n0 + self.n_tile)
        bd = dst["b"]
        bd[:kb1 - kb0, :n1 - n0].copy_(b_h[kb0:kb1, n0:n1])
        bd[kb1 - kb0:].zero_()
        bd[:kb1 - kb0, n1 - n0:].zero_()

    def _chunk_tensor(self, t: Dict[str, torch.Tensor]) -> SparseTensor:
        """A staged chunk as a SparseTensor of ``WCHUNK*K0`` columns."""
        d = self._d
        kc = self.window_chunk * d.k0
        data = PackedSpMM(vals=t["vals"], cols=t["cols"], rows=t["rows"],
                          q=t["q"], nse=t["nse"], m=self.m, k=kc, tm=d.tm,
                          k0=d.k0, chunk=d.chunk, interleaved=d.interleaved,
                          nnz=0)
        return SparseTensor(data=data, format=Format.HFLEX,
                            shape=(self.m, kc))

    def _host_operands(self, b, values):
        b_h = as_dense(b, "cpu")
        if tuple(b_h.shape) != (self.k, self.n) or b_h.dtype != self.dtype:
            raise ValueError(
                f"plan expects b of shape {(self.k, self.n)} dtype "
                f"{self.dtype}, got {tuple(b_h.shape)} {b_h.dtype}")
        vals_h = self._d.vals
        if values is not None:
            vals_h = as_dense(values, "cpu")
            if tuple(vals_h.shape) != tuple(self._d.vals.shape):
                raise ValueError(
                    f"values must have the packed shape "
                    f"{tuple(self._d.vals.shape)}, got "
                    f"{tuple(vals_h.shape)}")
        return b_h, vals_h

    def _stager(self) -> _Staging:
        if self._staging is None:
            self._staging = _Staging(self._shapes, self.device)
        return self._staging

    def _grid(self):
        return [(j, i) for j in range(self.n_tiles) for i in range(self.steps)]

    def _chunks(self, b_h: torch.Tensor, vals_h: torch.Tensor):
        """The staging half of a run: yields ``((j, i), chunk)`` for every
        step of the grid, ``chunk`` the step's tensors on the compute
        device, staged while the previous step computes. A chunk's slot is
        released, and the next chunk staged, when the consumer asks for the
        next one, so the consumer queues its work on a chunk first."""
        st = self._stager()
        grid = self._grid()

        def stage(t):
            j, i = grid[t]
            st.stage(t % 2, lambda h: self._fill_chunk(
                h, i, j * self.n_tile, b_h, vals_h))

        stage(0)
        for t, pos in enumerate(grid):
            yield pos, st.acquire(t % 2)
            st.release(t % 2)
            if t + 1 < len(grid):
                stage(t + 1)

    def _compute(self, chunks, c, alpha, beta) -> torch.Tensor:
        """The compute half of a run over ``chunks`` (pairs as
        :meth:`_chunks` yields them, in grid order): the steps, one
        epilogue per column tile, and, with ``n_tiles > 1``, each stripe's
        copy into a host result, waited for one tile late."""
        stream, opts = self._stream, self.opts
        st = self._stager()
        out = None
        if self.n_tiles > 1:
            out = torch.empty((self.m, self.n), dtype=self.dtype)
        pending = None          # tile j-1's stripe, on its way to the host
        for (j, i), chunk in chunks:
            if i == 0:
                acc = stream.init(self.a, self.n_tile, device=self.device,
                                  **opts)
            acc = stream.step(self._chunk_tensor(chunk), chunk["b"], acc,
                              **opts)
            if i + 1 < self.steps:
                continue
            raw = stream.collect(self.a, acc, self.n_tile, **opts)
            stripe = _bk.stream_finish(raw, self._c_tile(c, j), alpha, beta,
                                       self.dtype)
            if out is None:
                # Returned after the loop, not here: the staging half
                # releases the last step's slot only when asked for more.
                result = stripe
                continue
            handle = (st.start_to_host(stripe), j * self.n_tile)
            if pending is not None:
                self._land(out, *pending)
            pending = handle
        if out is None:
            return result
        self._land(out, *pending)
        return out

    def _land(self, out, handle, n0) -> None:
        n1 = min(self.n, n0 + self.n_tile)
        out[:, n0:n1] = _Staging.land(handle)[:, :n1 - n0]

    def _c_tile(self, c, j: int) -> torch.Tensor:
        """The ``(M, n_tile)`` epilogue operand of tile ``j`` on the compute
        device: cached zeros without ``c``; the tail tile zero-padded."""
        if c is None:
            if self._zero_c is None:
                self._zero_c = torch.zeros((self.m, self.n_tile),
                                           dtype=self.dtype,
                                           device=self.device)
            return self._zero_c
        if self.n_tiles == 1:
            return c
        n0 = j * self.n_tile
        n1 = min(self.n, n0 + self.n_tile)
        ct = torch.zeros((self.m, self.n_tile), dtype=self.dtype,
                         pin_memory=self.device.type == "cuda")
        ct[:, :n1 - n0] = c[:, n0:n1]
        return ct.to(self.device, non_blocking=True)

    def run(self, b, c=None, alpha=1.0, beta=0.0, *, values=None
            ) -> torch.Tensor:
        """Stream the SpMM over the (N-tile x K-chunk) grid: the staging
        half (:meth:`_chunks`) feeds the compute half (:meth:`_compute`).

        ``b`` is ``(K, N)`` of the planned dtype, a host array or CPU
        tensor by preference (a device tensor is brought to the host
        first). ``values`` substitutes a non-zero payload of A's packed
        shape, read chunk by chunk like the plan's own."""
        b_h, vals_h = self._host_operands(b, values)
        if c is not None:
            c = as_dense(c, self.device if self.n_tiles == 1 else "cpu")
            c = c.to(self.dtype)
            if tuple(c.shape) != (self.m, self.n):
                raise ValueError(f"c must have shape {(self.m, self.n)}, "
                                 f"got {tuple(c.shape)}")
        alpha, beta = _ab_operands(self._ab_cache, alpha, beta, self.device)
        with torch.no_grad():
            y = self._compute(self._chunks(b_h, vals_h), c, alpha, beta)
        PLAN_STATS["dispatches"] += self.n_tiles * (self.steps + 1)
        PLAN_STATS["window_dispatches"] += self.steps * self.n_tiles
        return y

    def __call__(self, b, c=None, alpha=1.0, beta=0.0, **kw):
        return self.run(b, c, alpha, beta, **kw)

    def __repr__(self) -> str:
        return (f"StreamingPlan(shape=({self.m}, {self.k})@{self.n}, "
                f"backend={self.backend!r}, window_chunk="
                f"{self.window_chunk}, steps={self.steps}, "
                f"n_tile={self.n_tile}, n_tiles={self.n_tiles}, "
                f"device={self.device})")


def plan(
    a: SparseTensor,
    n: int,
    *,
    backend: str = "auto",
    dtype=torch.float32,
    device=None,
    device_bytes: Union[int, str, None] = None,
    stream: Optional[bool] = None,
    window_chunk: Optional[int] = None,
    n_tile: Optional[int] = None,
    **opts,
) -> Union[SpmmPlan, StreamingPlan]:
    """Prepare ``alpha * A @ b + beta * c`` for dense operands of width
    ``n``.

    ``device_bytes`` (an int budget, or ``"auto"`` for
    :func:`device_memory_budget`) selects the out-of-core tier: when the
    resident working set, A's payload + ``b`` + ``c`` + the output,
    exceeds it, a :class:`StreamingPlan` is returned. ``stream=True`` or
    ``False`` forces the choice; ``window_chunk`` and ``n_tile`` pin the
    streaming grid (otherwise sized from the budget).

    ``device`` is where the plan computes. By default that is ``"cuda"``
    for a streaming plan, and for any plan given a ``device_bytes`` budget
    (a budget of device memory asks for the card, whatever A's device);
    otherwise it is A's device, as for ``spmm``. A plan for ``"cuda"`` on
    a machine without a card raises; it never computes on the CPU
    instead. Only ``device="cpu"`` computes a budgeted plan on the host.
    """
    if device is None and (stream or device_bytes is not None):
        device = "cuda"
    if device is not None:
        device = _device(device)              # raises without a card
    budget: Optional[int] = None
    if device_bytes is not None:
        budget = (device_memory_budget() if device_bytes == "auto"
                  else int(device_bytes))
    if stream is None:
        stream = False
        if budget is not None:
            m, k = a.shape
            working = a.nbytes + (k * n + 2 * m * n) * dtype.itemsize
            stream = working > budget
    if stream:
        return StreamingPlan(a, n, backend, opts, dtype=dtype, device=device,
                             device_bytes=budget, window_chunk=window_chunk,
                             n_tile=n_tile)
    if n_tile is not None:
        raise ValueError("n_tile applies to streaming plans only (pass "
                         "stream=True or a device_bytes budget)")
    return SpmmPlan(a, n, backend, opts, dtype=dtype, device=device)
