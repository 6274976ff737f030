"""Inference serving: a dynamic-batching inpainting server over HTTP
(counterpart of video_filler_tpu/serve.py), on one device, or on N with
``dataParallel=N``.

* **Dynamic batching**: concurrent requests are gathered into one
  fixed-size batch (the tail padded), so single-image requests ride a full
  batch under load, and at most ``max_delay_ms`` of latency is added when
  there is none.
* **uint8 at the boundary**: requests and responses carry uint8 pixels;
  normalising, the mask composite and denormalising run on the device, so
  the host<->device copies are a quarter of the f32 size.
* **One device client**: one worker thread runs every batch, so the HTTP
  threads never contend for the device.
* **dataParallel=N** (JAX serve.py:341-365): N replicas of G in one
  process, on ``cuda:0..N-1`` (all on the CPU with ``device=cpu``); each
  padded batch is split into N row blocks that run concurrently, one
  thread per replica, and are joined in order.  batchSize must divide by
  N, and N may not exceed the cards there are.

API (numpy .npz bodies):
  POST /inpaint   {"ctx": (H,W,C) or (B,H,W,C) uint8 masked context,
                   optional "mask": (H,W,1) or (B,H,W,1) uint8, nonzero =
                   inside the hole; optional "noise": (nz,), (1,1,nz) or
                   (B,1,1,nz) f32 for a noiseGen G, broadcast to the rows
                   (omitted: zeros, so the result is deterministic)}
                  -> {"out": uint8 of ctx's shape}:
                   video/logo: G's output inside the mask, ctx outside (the
                     whole G output without a mask);
                   video3d: the same on channel-folded clips (S,S,nc*predLen),
                     S = 4*2**video3dLevels; the clip is unfolded to
                     (T,S,S,nc) around the 3-D G and its prediction folded
                     back;
                   center: the predicted 64² hole pasted into ctx, the
                     overlapPred ring kept from ctx (demo.lua:73-76); masks
                     are refused;
                   wholeim: the raw 27-channel -> 12-channel patch arrays;
                     with frameH/frameW, whole frames (frameH, frameW, nc)
                     and a required mask: the 3x3 patch grid through G once,
                     the 2x2 predicted patches scattered back (overlaps
                     averaged) and composited inside the mask;
                   video with frameH/frameW: predLen channel-folded whole
                     frames (frameH, frameW, nc*predLen) and a required
                     mask: mask-fill, pad to fineSize multiples, tiles with
                     the vflip-top-tiles trick, the optional initName
                     cascade (withInit=1), one G forward over every tile,
                     scatter back, composite inside the mask
                     (test_vid_wholeim.lua:159-220).
  GET  /stats     {"requests", "items", "batches", "expired", "rejected",
                   "avg_fill", "p50_ms", "p95_ms"}
  GET  /healthz   200 "ok" (503 while draining)

Overload: the backlog is bounded in rows (4 batches' worth); a request over
budget gets 503 at once.  Queued requests whose client has given up
(REQUEST_TIMEOUT_S) are dropped unprocessed, and a request that times out
gets 504.  A device error fails that batch's requests with 500; the worker
lives on.  SIGTERM drains: new requests get 503, every accepted one is
answered, then the process exits.

CLI:
    python -m video_filler_tpu_torch.serve regime=video device=cuda \\
        net=checkpoints/..._state.npz predLen=4 batchSize=64 \\
        display_port=8100 [serveMaxDelayMs=5] [frameH=360 frameW=480]

The model options (predLen, nBottleneck, fineSize, ...) must match the
checkpoint, as in every eval CLI.
"""

from __future__ import annotations

import io
import json
import math
import queue
import sys
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F

from video_filler_tpu_torch.config import Opt, from_args, resolve_device
from video_filler_tpu_torch.eval.common import generator_spec, load_generator
from video_filler_tpu_torch.eval.tiling import VFLIP_TOP_TILES
from video_filler_tpu_torch.models import video3d_fine_size
from video_filler_tpu_torch.ops import masks
from video_filler_tpu_torch.ops.image import (
    denormalize_to_uint8,
    normalize_uint8,
)
from video_filler_tpu_torch.ops.layers3d import fold_time, unfold_time
from video_filler_tpu_torch.utils.httpbase import QuietHandler

REQUEST_TIMEOUT_S = 60.0  # the client's wait; queued entries older than
                          # this are dropped unprocessed (nobody reads them)


class ServerOverloaded(RuntimeError):
    """Backlog full or draining: refuse now (HTTP 503)."""


class RequestTimeout(RuntimeError):
    """The request expired before its batch completed (HTTP 504)."""


def _video_frame_fn(opt: Opt, gen, init_gen, fs: int):
    """(B, frameH, frameW, nc*predLen) uint8 frames + (B, frameH, frameW, 1)
    mask -> the composited inpaint: mask-fill, pad bottom-right to fineSize
    multiples with -1 (the reference normalizes after writing into a zero
    canvas, test_vid_wholeim.lua:139-141), tiles with the vflip trick, the
    optional initializer cascade, one G forward, scatter back, composite
    inside the mask only (test_vid_wholeim.lua:159-220)."""
    fh, fw = opt.frameH, opt.frameW
    oph, opw = math.ceil(fh / fs) * fs, math.ceil(fw / fs) * fs
    n_th, n_tw = oph // fs, opw // fs
    pad = (0, 0, 0, opw - fw, 0, oph - fh)   # F.pad: last dim first

    def gather(x):
        """(B, oph, opw, C) -> (B*nT, fs, fs, C), row-major tiles, the
        leftmost VFLIP_TOP_TILES of the top row flipped vertically
        (eval/tiling.gather_tiles, batched)."""
        tiles = []
        for th in range(n_th):
            for tw in range(n_tw):
                t = x[:, th * fs:(th + 1) * fs, tw * fs:(tw + 1) * fs]
                if th == 0 and tw < VFLIP_TOP_TILES:
                    t = torch.flip(t, dims=[1])
                tiles.append(t)
        t = torch.stack(tiles, dim=1)
        return t.reshape((-1,) + tuple(t.shape[2:]))

    def scatter(y, b):
        """Inverse of gather, the trick tiles flipped back."""
        y = y.reshape((b, n_th * n_tw) + tuple(y.shape[1:]))
        rows, i = [], 0
        for th in range(n_th):
            cols = []
            for tw in range(n_tw):
                t = y[:, i]
                if th == 0 and tw < VFLIP_TOP_TILES:
                    t = torch.flip(t, dims=[1])
                cols.append(t)
                i += 1
            rows.append(torch.cat(cols, dim=2))
        return torch.cat(rows, dim=1)

    def fn(frame_u8, mask_u8):
        x = normalize_uint8(frame_u8)
        m = mask_u8 > 0
        xp = F.pad(masks.apply_logo_mask(x, m, opt.maskValue), pad,
                   value=-1.0)
        mp = F.pad(m.to(torch.uint8), pad) > 0   # the pad is not inpainted
        tiles = gather(xp)
        if init_gen is not None:
            tiles = masks.fill_in(tiles, gather(mp), init_gen(tiles))
        frames = scatter(gen(tiles).float(), frame_u8.shape[0])
        out = torch.where(mp, frames, xp)
        return denormalize_to_uint8(out[:, :fh, :fw])

    return fn


def _wholeim_frame_fn(opt: Opt, gen, fs: int):
    """(B, frameH, frameW, nc) uint8 frame + mask -> the composited inpaint:
    mask-fill (donkey_wholeim.lua:161-164), the arrh x arrw patch grid into
    channels (:195-211), one G forward, the out_h x out_w predicted patches
    scattered back with overlaps averaged, and the composite inside the
    mask where a predicted patch covers it (test_vid_wholeim.lua:207-220).
    Masked pixels outside the coverage keep the fill value, as the model
    saw them in training."""
    arrh, arrw, outh, outw, nc = (opt.array_h, opt.array_w, opt.out_h,
                                  opt.out_w, opt.nc)

    def fn(frame_u8, mask_u8):
        x = normalize_uint8(frame_u8)
        m = mask_u8 > 0
        xm = masks.apply_logo_mask(x, m, opt.maskValue)
        h, w = x.shape[1], x.shape[2]
        steph = (h - fs) // max(arrh - 1, 1)
        stepw = (w - fs) // max(arrw - 1, 1)
        g_in = torch.cat(
            [xm[:, hi * steph:hi * steph + fs, wi * stepw:wi * stepw + fs]
             for hi in range(arrh) for wi in range(arrw)], dim=-1)
        pred = gen(g_in).float()
        acc = torch.zeros_like(x)
        cnt = torch.zeros((1, h, w, 1), device=x.device)
        for hi in range(outh):
            for wi in range(outw):
                oi = hi * outw + wi
                ys, xs = hi * steph, wi * stepw
                acc[:, ys:ys + fs, xs:xs + fs] += \
                    pred[..., oi * nc:(oi + 1) * nc]
                cnt[:, ys:ys + fs, xs:xs + fs] += 1.0
        mean_pred = acc / cnt.clamp(min=1.0)
        return denormalize_to_uint8(torch.where(m & (cnt > 0), mean_pred,
                                                xm))

    return fn


class _HTTPServer(ThreadingHTTPServer):
    # A burst of concurrent clients waits in the listen backlog; at the
    # socketserver default of 5 the kernel resets the overflow.
    request_queue_size = 1024


class InpaintServer:
    """Dynamic-batching HTTP server around one generator on one device."""

    def __init__(self, opt: Opt, regime: str, net_path: str,
                 host: str = "localhost", port: int = 0,
                 max_delay_ms: float = 5.0, device_thread: bool = True):
        gspec = generator_spec(opt, regime)  # noiseGen on video3d: exit
        self.noise_gen, self.nz = bool(opt.noiseGen), int(opt.nz)
        self.device = resolve_device(opt)
        self.batch = int(opt.batchSize)
        self.devices = replica_devices(opt, self.device, self.batch)
        self.fs = fs = int(opt.fineSize)
        video3d = regime == "video3d"
        if video3d:
            # The video regime's wire format: channel-folded uint8 clips
            # (B,S,S,nc*predLen), unfolded around the 3-D G.
            self.fs = fs = video3d_fine_size(opt)
            self.composable, self.in_c = True, opt.nc * opt.predLen
        else:
            # Composite inside the mask needs output geometry == input
            # (video, logo).  center predicts the 64² hole, pasted into a
            # fixed region of ctx; patch-mode wholeim predicts other
            # channels: raw output.
            self.composable = (gspec.nc_in == gspec.nc_out
                               and gspec.out_size == fs)
            self.in_c = gspec.nc_in
        self.center_paste = regime == "center"
        full = opt.frameH > 0 or opt.frameW > 0
        self.wholeim_frame = regime == "wholeim" and full
        self.video_frame = regime == "video" and full
        self.in_h = self.in_w = fs
        if full and (opt.frameH < fs or opt.frameW < fs):
            raise SystemExit(
                f"frameH/frameW must both be >= fineSize {fs} (got "
                f"{opt.frameH}x{opt.frameW}): the patch grid must fit the "
                "frame")
        if self.noise_gen and full:
            # the JAX server refuses it in the video frame mode; its
            # wholeim frame function passes G no z
            raise SystemExit(f"{regime} full-frame serving does not compose "
                             "with noiseGen")
        if self.wholeim_frame:
            if opt.predLen != 1:
                raise SystemExit("wholeim full-frame serving needs predLen=1 "
                                 "(dataset_wholeim.lua:402 asserts "
                                 "length==1)")
            self.in_h, self.in_w, self.in_c = opt.frameH, opt.frameW, opt.nc
        if self.video_frame:
            self.in_h, self.in_w = opt.frameH, opt.frameW
            self.composable = False    # the frame function composites
        self.max_delay = max_delay_ms / 1000.0

        # One device function per replica, each with its own copy of G.
        self._device_fns = [self._build_device_fn(opt, regime, net_path, dev)
                            for dev in self.devices]
        self._pool = None
        if len(self.devices) > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(len(self.devices),
                                            thread_name_prefix="replica")

        # The backlog is bounded in rows (a 64-row POST charges 64): four
        # full batches.  Over budget is refused at once (503).
        self._queue: queue.Queue = queue.Queue()
        self._max_pending_rows = max(4 * self.batch, 16)
        self._pending_rows = 0
        self._draining = False
        self._closed = False
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "items": 0, "batches": 0,
                       "expired": 0, "rejected": 0}
        self._latencies: list[float] = []

        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True   # fixed shapes
        # Warm up on one full padded batch before taking traffic, on the
        # thread that will run the batches: cuDNN times its algorithms on
        # the first call and keeps the plans per thread, so a warm-up on
        # another thread leaves the first client to pay again.
        # device_thread=False: the caller runs the batch loop itself
        # (run_forever) on this thread, e.g. the main thread, where the
        # CLI's SIGTERM handler runs.
        self._worker = None
        if device_thread:
            warm: Future = Future()
            self._worker = threading.Thread(target=self._run_batches,
                                            args=(warm,), daemon=True)
            self._worker.start()
            warm.result()        # a failed warm-up raises here
        else:
            with torch.inference_mode():
                self._warm_up()
        self._srv = _HTTPServer((host, port), self._handler_class())
        self.port = self._srv.server_address[1]
        self._http_thread = threading.Thread(target=self._srv.serve_forever,
                                             daemon=True)
        self._http_thread.start()

    # ---- device side ----------------------------------------------------

    def _build_device_fn(self, opt: Opt, regime: str, net_path: str,
                         device: torch.device):
        """The mode's function on ``device``, around a generator loaded
        there: (ctx_u8, mask_u8[, noise]) device tensors -> uint8."""
        fs = self.fs
        gen = load_generator(opt, regime, net_path, device)
        if self.video_frame:
            # initializer cascade (test_vid_wholeim.lua:178-190)
            init_gen = (load_generator(opt, regime, opt.initName, device)
                        if opt.withInit and opt.initName else None)
            return _video_frame_fn(opt, gen, init_gen, fs)
        if self.wholeim_frame:
            return _wholeim_frame_fn(opt, gen, fs)
        composable, center_paste = self.composable, self.center_paste
        frames, noise_gen = opt.predLen, self.noise_gen
        video3d = regime == "video3d"

        def fn(ctx_u8, mask_u8, noise=None):
            x = normalize_uint8(ctx_u8)
            if video3d:
                out = fold_time(gen(unfold_time(x, frames)).float())
            else:
                out = gen((x, noise) if noise_gen else x).float()
            if composable:
                # clients often send 0/255 masks: nonzero = in the hole
                m = (mask_u8 > 0).float()
                out = m * out + (1.0 - m) * x
            elif center_paste:
                out = masks.paste_center(x, out, opt.overlapPred)
            return denormalize_to_uint8(out)

        return fn

    def _run_replica(self, i: int, arrays: list[np.ndarray]) -> np.ndarray:
        """Replica ``i`` on its row block: to its device, its function,
        the uint8 result back."""
        dev = self.devices[i]
        with torch.inference_mode():
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            return self._device_fns[i](*args).cpu().numpy()

    def _serve_fn(self, ctx: np.ndarray, mask: np.ndarray,
                  noise: np.ndarray | None = None) -> np.ndarray:
        """One padded batch: uint8 ctx (batch, in_h, in_w, in_c), mask
        (batch, in_h, in_w, 1) and, for a noiseGen G, f32 noise
        (batch, 1, 1, nz) to the device, the mode's function there, the
        uint8 result back; under dataParallel, one row block per replica,
        concurrently, joined in order."""
        arrays = [ctx, mask] + ([noise] if self.noise_gen else [])
        if self._pool is None:
            return self._run_replica(0, arrays)
        n = len(self.devices)
        blocks = [[np.ascontiguousarray(b) for b in np.split(a, n)]
                  for a in arrays]
        futs = [self._pool.submit(self._run_replica, i,
                                  [blk[i] for blk in blocks])
                for i in range(n)]
        return np.concatenate([f.result() for f in futs])

    def _expire(self, fut: Future) -> None:
        if not fut.done():
            fut.set_exception(TimeoutError("request expired in queue"))
        with self._stats_lock:
            self._stats["expired"] += 1

    def _release(self, rows: int) -> None:
        with self._stats_lock:
            # max(0, ...) tolerates entries injected behind infer()'s back
            self._pending_rows = max(0, self._pending_rows - rows)

    def _pop_live(self, timeout: float):
        """The next request whose client still waits (None on timeout).
        Entries past their deadline are dropped unprocessed."""
        end = time.perf_counter() + timeout
        while True:
            try:
                item = self._queue.get(
                    timeout=max(end - time.perf_counter(), 1e-4))
            except queue.Empty:
                return None
            self._release(item[0].shape[0])   # freed on pop, live or not
            if time.perf_counter() <= item[3]:
                return item
            self._expire(item[2])

    def _noise_arg(self) -> tuple:
        """The batch's noise argument of ``_serve_fn``: zeros (B,1,1,nz)
        for a noiseGen G, none otherwise."""
        return ((np.zeros((self.batch, 1, 1, self.nz), np.float32),)
                if self.noise_gen else ())

    def _warm_up(self) -> None:
        self._serve_fn(
            np.zeros((self.batch, self.in_h, self.in_w, self.in_c), np.uint8),
            np.ones((self.batch, self.in_h, self.in_w, 1), np.uint8),
            *self._noise_arg())

    def _run_batches(self, warm: Future | None = None) -> None:
        """The single device client: drain the queue into padded batches,
        after the warm-up when ``warm`` waits for it.  ``inference_mode``
        is thread-local, so it is entered here, on the thread that runs the
        batches."""
        with torch.inference_mode():
            if warm is not None:
                try:
                    self._warm_up()
                except Exception as e:  # noqa: BLE001 -- raised in __init__
                    warm.set_exception(e)
                    return
                warm.set_result(None)
            self._batch_loop()

    def _batch_loop(self) -> None:
        carry = None  # a request that did not fit the last batch: runs first
        while not self._closed:
            if carry is not None:
                item, carry = carry, None
                # The carry kept its row reservation while held (the backlog
                # bound counts it); release it now, and re-check its
                # deadline: it may have expired while the last batch ran.
                self._release(item[0].shape[0])
                if time.perf_counter() > item[3]:
                    self._expire(item[2])
                    continue
            else:
                item = self._pop_live(0.2)
                if item is None:
                    if self._draining:
                        # Exit only when no accepted rows remain.  infer()
                        # checks _draining and reserves rows under the same
                        # lock, so a request racing the drain is either
                        # refused or visible here.
                        with self._stats_lock:
                            drained = self._pending_rows == 0
                        if drained and self._queue.empty():
                            return
                    continue
            items = [item]
            deadline = time.perf_counter() + self.max_delay
            rows = item[0].shape[0]
            while rows < self.batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                nxt = self._pop_live(remaining)
                if nxt is None:
                    break
                if rows + nxt[0].shape[0] > self.batch:
                    # the head of the next batch (back to the queue's tail
                    # it would wait behind later arrivals); it keeps its
                    # row reservation while held
                    carry = nxt
                    with self._stats_lock:
                        self._pending_rows += nxt[0].shape[0]
                    break
                items.append(nxt)
                rows += nxt[0].shape[0]

            try:
                # Assembly inside the try: a malformed direct infer() fails
                # its own futures, not the worker.
                ctx = np.zeros((self.batch, self.in_h, self.in_w, self.in_c),
                               np.uint8)
                mask = np.ones((self.batch, self.in_h, self.in_w, 1),
                               np.uint8)
                # rows without noise get zeros: a deterministic result
                noise = self._noise_arg()
                at = 0
                for c, m, _, _, *z in items:
                    ctx[at:at + c.shape[0]] = c
                    if m is not None:
                        mask[at:at + c.shape[0]] = m
                    if z:
                        noise[0][at:at + c.shape[0]] = z[0]
                    at += c.shape[0]
                out = self._serve_fn(ctx, mask, *noise)
                at = 0
                for c, _, fut, *_ in items:
                    fut.set_result(out[at:at + c.shape[0]])
                    at += c.shape[0]
            except Exception as e:  # device errors go to the clients (500)
                for _, _, fut, *_ in items:
                    if not fut.done():
                        fut.set_exception(e)
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["items"] += rows
        if carry is not None:  # do not strand a held request at shutdown
            self._release(carry[0].shape[0])
            carry[2].set_exception(RuntimeError("server closed"))

    def infer(self, ctx: np.ndarray, mask: np.ndarray | None,
              noise: np.ndarray | None = None) -> np.ndarray:
        """Queue one request (B, in_h, in_w, in_c) uint8 and wait for its
        rows.  ``noise``: (B,1,1,nz) for a noiseGen G (default zeros)."""
        n = ctx.shape[0]
        if n > self.batch:
            raise ValueError(f"request of {n} rows exceeds the server batch "
                             f"{self.batch}: split it client-side")
        # Validated before queueing: a mis-shaped array must fail here, not
        # poison a shared batch in the worker.
        if ctx.shape[1:] != (self.in_h, self.in_w, self.in_c):
            raise ValueError(f"ctx rows must be ({self.in_h},{self.in_w},"
                             f"{self.in_c}), got {ctx.shape[1:]}")
        if ctx.dtype != np.uint8:
            raise ValueError(f"ctx must be uint8 [0,255], got {ctx.dtype}")
        if (self.wholeim_frame or self.video_frame) and mask is None:
            # the all-ones default would mask-fill the whole frame
            raise ValueError("full-frame serving requires a mask "
                             "(which pixels to inpaint)")
        if mask is not None and mask.shape != (n, self.in_h, self.in_w, 1):
            raise ValueError(f"mask must be ({n},{self.in_h},{self.in_w},1), "
                             f"got {mask.shape}")
        if mask is not None and mask.dtype != np.uint8:
            # a float [0,1] mask cast into the uint8 batch would truncate
            # to 0: a silent no-op inpaint
            raise ValueError(f"mask must be uint8 {{0,1}}, got {mask.dtype}"
                             " -- binarize client-side")
        if noise is not None:
            if not self.noise_gen:
                raise ValueError("this server's generator takes no noise "
                                 "(noiseGen=0)")
            if noise.shape != (n, 1, 1, self.nz):
                raise ValueError(f"noise must be ({n},1,1,{self.nz}), got "
                                 f"{noise.shape}")
            noise = np.asarray(noise, np.float32)
        t0 = time.perf_counter()
        fut: Future = Future()
        with self._stats_lock:
            # _draining is read under the lock that reserves rows (see
            # _batch_loop's drained exit)
            if self._draining:
                self._stats["rejected"] += 1
                raise ServerOverloaded("server draining (shutdown in "
                                       "progress): request refused")
            if self._pending_rows + n > self._max_pending_rows:
                self._stats["rejected"] += 1
                raise ServerOverloaded(
                    f"request queue full ({self._pending_rows} rows pending, "
                    f"budget {self._max_pending_rows}): retry with backoff")
            self._pending_rows += n
        # (ctx, mask, future, deadline[, noise]): noise only where posted
        self._queue.put_nowait((ctx, mask, fut, t0 + REQUEST_TIMEOUT_S)
                               + (() if noise is None else (noise,)))
        try:
            out = fut.result(timeout=REQUEST_TIMEOUT_S)
        except (TimeoutError, FutureTimeoutError) as e:
            # the wait ran out, or the queue dropped the expired entry
            raise RequestTimeout(str(e) or "request timed out") from None
        with self._stats_lock:
            self._stats["requests"] += 1
            self._latencies.append((time.perf_counter() - t0) * 1000.0)
            del self._latencies[:-10_000]
        return out

    # ---- HTTP side ------------------------------------------------------

    def _parse(self, body: bytes):
        """(ctx, mask, noise, squeeze) of a POST body; ValueError -> 400."""
        with np.load(io.BytesIO(body), allow_pickle=False) as data:
            ctx = data["ctx"]
            mask = data["mask"] if "mask" in data.files else None
            noise = data["noise"] if "noise" in data.files else None
        squeeze = ctx.ndim == 3
        if squeeze:
            ctx = ctx[None]
            mask = None if mask is None else mask[None]
        if noise is not None:
            if not self.noise_gen:
                raise ValueError("this server's generator takes no noise "
                                 "(noiseGen=0)")
            noise = np.asarray(noise, np.float32)
            if noise.ndim in (1, 3):   # (nz,) or (1,1,nz): every row
                noise = np.broadcast_to(noise.reshape(1, 1, 1, -1),
                                        (ctx.shape[0], 1, 1, noise.shape[-1]))
            if noise.shape != (ctx.shape[0], 1, 1, self.nz):
                raise ValueError(f"noise must be (B,1,1,{self.nz}), got "
                                 f"{noise.shape}")
        ih, iw, c = self.in_h, self.in_w, self.in_c
        if ctx.dtype != np.uint8 or ctx.shape[1:] != (ih, iw, c):
            raise ValueError(f"ctx must be uint8 (B,{ih},{iw},{c}), got "
                             f"{ctx.dtype} {ctx.shape}")
        if mask is not None and not (self.composable or self.wholeim_frame
                                     or self.video_frame):
            raise ValueError(
                "mask compositing needs matching in/out geometry (video/logo "
                "regimes) or a full-frame mode (frameH/frameW); center "
                "models inpaint their fixed center hole (no mask input) and "
                "patch-mode wholeim serves the raw G output")
        if mask is not None and mask.shape != (ctx.shape[0], ih, iw, 1):
            raise ValueError(f"mask must be (B,{ih},{iw},1), got "
                             f"{mask.shape}")
        return ctx, mask, noise, squeeze

    def _handler_class(self):
        server = self

        class Handler(QuietHandler):
            def do_GET(self):
                if self.path == "/healthz":
                    # a draining server leaves the balancer's rotation now
                    if server._draining:
                        self._send(503, "text/plain", b"draining")
                    else:
                        self._send(200, "text/plain", b"ok")
                elif self.path == "/stats":
                    self._send(200, "application/json",
                               json.dumps(server.stats()).encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path != "/inpaint":
                    self._send(404, "text/plain", b"not found")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    ctx, mask, noise, squeeze = server._parse(
                        self.rfile.read(n))
                except Exception as e:  # noqa: BLE001 -- any bad body
                    self._send(400, "text/plain", str(e).encode())
                    return
                try:
                    out = server.infer(ctx, mask, noise)
                except ValueError as e:  # a client error: oversize batch
                    self._send(400, "text/plain", str(e).encode())
                    return
                except ServerOverloaded as e:
                    self._send(503, "text/plain", str(e).encode())
                    return
                except RequestTimeout as e:
                    self._send(504, "text/plain", str(e).encode())
                    return
                except Exception as e:  # noqa: BLE001 -- a device error
                    self._send(500, "text/plain", str(e).encode())
                    return
                buf = io.BytesIO()
                np.savez(buf, out=(out[0] if squeeze else out))
                self._send(200, "application/octet-stream", buf.getvalue())

        return Handler

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
            lat = sorted(self._latencies)
        s["avg_fill"] = (s["items"] / (s["batches"] * self.batch)
                         if s["batches"] else 0.0)
        s["p50_ms"] = lat[len(lat) // 2] if lat else 0.0
        s["p95_ms"] = lat[int(len(lat) * 0.95)] if lat else 0.0
        return s

    def run_forever(self) -> None:
        """Run the batch loop on the calling thread (device_thread=False);
        returns after initiate_drain() once the backlog is answered."""
        self._run_batches()

    def initiate_drain(self) -> None:
        """Graceful shutdown: refuse new requests (503), answer every
        accepted one, then the batch loop returns.  Only sets a flag, so a
        signal handler may call it."""
        self._draining = True

    def close(self) -> None:
        self._closed = True
        self._srv.shutdown()
        self._srv.server_close()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        self._http_thread.join(timeout=2.0)
        if self._pool is not None:
            self._pool.shutdown(wait=True)


def replica_devices(opt: Opt, device: torch.device,
                    batch: int) -> list[torch.device]:
    """The devices of the ``dataParallel`` replicas: ``[device]`` for one;
    ``cuda:0..N-1`` on the card, N times the CPU with ``device=cpu``.
    batchSize must divide by N (the JAX server's words), and N may not
    exceed the cards there are."""
    n = max(int(opt.dataParallel), 1)
    if n == 1:
        return [device]
    if batch % n:
        raise SystemExit(f"batchSize {batch} must be divisible by "
                         f"dataParallel {n} (fixed padded device batches)")
    if device.type == "cpu":
        return [device] * n
    cards = torch.cuda.device_count()
    if n > cards:
        raise SystemExit(f"dataParallel {n} needs {n} cards, one replica "
                         f"each, but torch.cuda.device_count() is {cards}")
    return [torch.device("cuda", i) for i in range(n)]


def main(argv: list[str]) -> None:
    from video_filler_tpu_torch.config import split_regime
    regime, rest = split_regime(argv, default="video")
    opt = from_args(rest)
    if not opt.net:
        raise SystemExit("serve needs net=<checkpoint .npz or .t7>")
    srv = InpaintServer(opt, regime, opt.net, host=opt.serveHost,
                        port=opt.display_port,
                        max_delay_ms=opt.serveMaxDelayMs,
                        device_thread=False)
    print(f"serving {opt.net} (regime={regime}, batch={opt.batchSize}, "
          f"device={srv.device}) on http://{opt.serveHost}:{srv.port}/ -- "
          "POST /inpaint, GET /stats", flush=True)
    import signal
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: srv.initiate_drain())
    try:
        srv.run_forever()  # the batch loop on the main thread
        print("drained: every accepted request answered; shutting down",
              flush=True)
    except KeyboardInterrupt:
        pass
    srv.close()


def cli() -> None:
    main(sys.argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
