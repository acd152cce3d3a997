"""Batched txt2img HTTP server of the PyTorch port (counterpart of the JAX
package's scripts/serve.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.serve --port 8500 --max-batch 4 \\
        --default-image-size 512 --channels-list 320,640,1280,1280 ...
    curl -X POST localhost:8500/txt2img -d '{"prompt": "a cat"}' -o cat.png

The model is built once at startup; one batcher thread owns the card. It
groups same-signature requests (image size, steps, sampler, guidance,
karras) that arrive within ``--batch-window-ms``, pads the group to a
power-of-two bucket (a bounded set of batch shapes), runs one
``pipeline.sample`` per group and fans the images, or the error, back out.
Each request's seed drives its own row's init noise, so its image does not
depend on its batch mates (ddim, the default; the stochastic samplers' loop
draws come from the group's first seed): on the CPU it is the solo render's
bytes; on a card the library convolutions and GEMMs round bf16 differently
at another batch size, and the sampling loop can carry that far. The handler threads
touch no CUDA tensor: they queue requests and encode the uint8 images the
batcher hands back.

On a card each signature's reverse loop (a bucket's batch, the size, steps,
sampler, guidance, karras) is captured once as a CUDA graph at its first
batch, a warm-up run and a capture on the batcher thread, and replayed by
every later batch of that signature (the JAX server's jit cache:
``LatentDiffusion.sample_loop``); the graphs share one memory pool. So is
the text encoder's tower, once per batch of prompts (``CLIPModel.encode_text``).
``--warmup`` and ``--warmup-sizes`` capture the signatures they name, the
loop's and the encoder's, before the server listens. ``/reload`` copies the weights in place, so the
captured graphs stay valid and replay with the new weights, with no
capture. On the CPU the loop runs eagerly.

API (routes and status codes as the JAX server's):
    GET  /healthz                  -> {"status": "ok", "queue_depth": N, "samplers": [...], ...}
    POST /txt2img {"prompt": ...}  -> image/png; optional fields: negative_prompt, steps,
                                      guidance_scale, seed, sampler, karras, image_size
    POST /txt2img_async {...}      -> 202 {"request_id": "..."}
    GET  /progress/<request_id>    -> {"state": queued|running|done|error, "pct": ..., ...}
    GET  /result/<request_id>      -> image/png when done (202 with the progress before)
    POST /reload {"unet_checkpoint": path, "lora_checkpoint": path, "lora_scale": 1.0}
                                   -> {"status": "reloaded", ...}: the UNet's weights are
                                      swapped in place between batches, on the batcher thread,
                                      a LoRA (optional) merged into them in float32 first
A bad request is 400 JSON, an unknown route or id 404. ``/progress`` estimates
a running batch's share from an EMA of earlier runs of its signature. As the
JAX server, it takes no control image and no DeepCache per request.

``--device`` (default ``cuda``; without a card the server stops unless given
``--device cpu``) is the port's own flag. Weights staged under
``--model-dir`` are loaded (``models/build.py``), the rest are random, made
from ``--seed``, until a ``/reload``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import torch

from stable_diffusion_pytorch_tpu_torch.config import (
    AutoencoderConfig,
    BaseConfig,
    ClipConfig,
    DDPMConfig,
    UnetConfig,
    compat_from_cfg,
    load_config,
)
from stable_diffusion_pytorch_tpu_torch.models.build import (
    build_models,
    load_unet_weights,
    require_device,
    resolve_dtype,
)
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import SAMPLERS
from stable_diffusion_pytorch_tpu_torch.pipeline import sample
from stable_diffusion_pytorch_tpu_torch.utils.data import encode_png

logger = logging.getLogger("serve")


@dataclass
class ServeConfig(BaseConfig):
    host: str = field(default="127.0.0.1", metadata={"help": "bind address."})
    port: int = field(default=8500, metadata={"help": "bind port."})
    default_steps: int = field(default=50, metadata={"help": "default sampling steps."})
    default_image_size: int = field(default=64, metadata={"help": "default resolution."})
    max_batch: int = field(
        default=4, metadata={"help": "max requests fused into one device batch."}
    )
    batch_window_ms: int = field(
        default=20,
        metadata={"help": "how long the batcher waits for same-signature requests."},
    )
    warmup: bool = field(
        default=False,
        metadata={"help": "capture the default request signature's sampling loop at startup (on a card: a "
                  "warm-up run and a CUDA graph capture)."},
    )
    warmup_sizes: Optional[List[int]] = field(
        default=None,
        metadata={
            "help": "extra image resolutions to capture at startup (e.g. "
            "64,128,256) so the first request at each size pays no capture."
        },
    )


class _Pending:
    __slots__ = (
        "req", "event", "result", "error",
        "id", "state", "submit_time", "start_time", "done_time", "sig",
    )

    def __init__(self, req: dict):
        self.req = req
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.id = uuid.uuid4().hex
        self.state = "queued"
        self.submit_time = time.time()
        self.start_time = None
        self.done_time = None
        self.sig = None


class _ReloadJob:
    """A weight hot-swap; run by the batcher thread, the model's one user, so
    it falls between batches."""

    __slots__ = ("req", "event", "error")

    def __init__(self, req: dict):
        self.req = req
        self.event = threading.Event()
        self.error = None


def _signature(req: dict, cfg) -> tuple:
    return (
        int(req.get("image_size", cfg.serve.default_image_size)),
        int(req.get("steps", cfg.serve.default_steps)),
        str(req.get("sampler", "ddim")),
        float(req.get("guidance_scale", cfg.train.guidance_scale)),
        bool(req.get("karras", False)),
    )


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class SDService:
    """Builds the model once; one batcher thread drives the device: it alone
    makes CUDA calls, so it alone runs the sampling loops' captures (each
    capture in ``thread_local`` mode besides, so no other thread's CUDA call
    could break it)."""

    def __init__(self, cfg, compat, dtype: torch.dtype, device):
        self.cfg = cfg
        m = cfg.model
        self.model = build_models(
            UnetConfig(**m.unet.to_dict()), AutoencoderConfig(**m.autoencoder.to_dict()),
            ClipConfig(**m.clip.to_dict()), DDPMConfig(**m.ddpm.to_dict()),
            compat=compat, dtype=dtype, device=device, seed=cfg.train.seed,
            pretrained_dir=m.clip.model_dir, logger=logger,
        )
        self.queue: "queue.Queue" = queue.Queue()
        self.requests_served = 0
        self.batches_run = 0
        self.reloads = 0
        self.current_checkpoint = None  # the seeded weights until /reload
        self._shutdown = False
        # async requests by id, and each signature's batch duration EMA (for /progress)
        self.jobs: dict = {}
        self._jobs_lock = threading.Lock()
        self._sig_ema: dict = {}
        self.batcher = threading.Thread(target=self._batch_loop, name="sd-batcher", daemon=True)
        self.batcher.start()

    # ------------------------------------------------------------------ #
    # batcher
    # ------------------------------------------------------------------ #

    def _batch_loop(self) -> None:
        window_s = self.cfg.serve.batch_window_ms / 1000.0
        max_batch = self.cfg.serve.max_batch
        while not self._shutdown:
            try:
                first = self.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:  # shutdown sentinel
                break
            if isinstance(first, _ReloadJob):
                self._do_reload(first)
                continue
            sig = _signature(first.req, self.cfg)
            group, deferred = [first], []
            # collect same-signature requests within the batching window
            while len(group) < max_batch:
                try:
                    nxt = self.queue.get(timeout=window_s)
                except queue.Empty:
                    break
                if nxt is None:
                    self._shutdown = True
                    break
                if not isinstance(nxt, _ReloadJob) and _signature(nxt.req, self.cfg) == sig:
                    group.append(nxt)
                else:  # another signature, or a swap after this batch: back on the queue
                    deferred.append(nxt)
            for d in deferred:
                self.queue.put(d)
            # grad mode is per thread: this one enters inference mode itself
            with torch.inference_mode():
                self._run_group(sig, group)

    def _run_group(self, sig: tuple, group: list) -> None:
        image_size, steps, sampler, guidance, karras = sig
        bucket = _bucket(len(group), self.cfg.serve.max_batch)
        prompts = [str(p.req.get("prompt", "")) for p in group]
        seeds = [int(p.req.get("seed", self.cfg.train.seed)) for p in group]
        # pad to the bucket, so that the batch shapes stay few (powers of two)
        while len(prompts) < bucket:
            prompts.append(prompts[0])
            seeds.append(seeds[0])
        negative = str(group[0].req.get("negative_prompt", ""))
        t_start = time.time()
        for pending in group:
            pending.state = "running"
            pending.start_time = t_start
            pending.sig = sig
        try:
            outs = sample(
                self.model, image_size=image_size, prompt=prompts, negative_prompt=negative,
                time_steps=steps, guidance_scale=guidance, sampler=sampler, karras=karras,
                seed=seeds, save_dir=None,
            )
            now = time.time()
            for pending, img in zip(group, outs):
                pending.result = img
                pending.state = "done"
                pending.done_time = now
                pending.event.set()
            # the first run of a signature seeds its EMA; later runs wash it out
            dur = now - t_start
            prev = self._sig_ema.get(sig)
            self._sig_ema[sig] = dur if prev is None else 0.7 * prev + 0.3 * dur
            self.requests_served += len(group)
            self.batches_run += 1
            if len(group) > 1:
                logger.info(f"batched {len(group)} requests (bucket {bucket}, sig {sig})")
        except Exception as e:  # noqa: BLE001 — fan the error out, keep serving
            logger.exception("batch failed")
            for pending in group:
                pending.error = e
                pending.state = "error"
                pending.done_time = time.time()
                pending.event.set()

    def _do_reload(self, job: _ReloadJob) -> None:
        """Copy a checkpoint's UNet weights, with a LoRA merged in when the
        request names one, into the live UNet in place: the modules, their
        dtype and device stay, so nothing is rebuilt, and the parameters keep
        their storage, so the captured sampling graphs stay valid and their
        next replays read the new weights (the JAX server's warm jit cache).
        A bad checkpoint or LoRA leaves the live UNet as it was."""
        try:
            path = load_unet_weights(self.model.unet, job.req["unet_checkpoint"],
                                     lora=job.req.get("lora_checkpoint"),
                                     lora_scale=float(job.req.get("lora_scale", 1.0)))
            self.current_checkpoint = path
            self.reloads += 1
            logger.info(f"hot-swapped UNet weights from {path}")
        except Exception as e:  # noqa: BLE001 — report to the caller, keep serving
            logger.exception("reload failed")
            job.error = e
        finally:
            job.event.set()

    def reload(self, req: dict, timeout: float = 600.0) -> str:
        if "unet_checkpoint" not in req:
            raise ValueError("reload needs 'unet_checkpoint'")
        job = _ReloadJob(req)
        self.queue.put(job)
        if not job.event.wait(timeout):
            raise TimeoutError("reload timed out")
        if job.error is not None:
            raise job.error
        return self.current_checkpoint

    # ------------------------------------------------------------------ #
    # request surface
    # ------------------------------------------------------------------ #

    def _submit(self, req: dict) -> _Pending:
        pending = _Pending(req)
        with self._jobs_lock:
            # forget finished jobs older than 10 minutes, so the table stays bounded
            cutoff = time.time() - 600.0
            for jid in [j for j, p in self.jobs.items() if p.done_time is not None and p.done_time < cutoff]:
                del self.jobs[jid]
            self.jobs[pending.id] = pending
        self.queue.put(pending)
        return pending

    @staticmethod
    def _to_png(pending: _Pending) -> bytes:
        return encode_png(pending.result)

    def txt2img_png(self, req: dict, timeout: float = 600.0) -> bytes:
        pending = self._submit(req)
        if not pending.event.wait(timeout):
            raise TimeoutError("sampling timed out")
        if pending.error is not None:
            raise pending.error
        return self._to_png(pending)

    def submit_async(self, req: dict) -> str:
        return self._submit(req).id

    def progress(self, request_id: str) -> Optional[dict]:
        with self._jobs_lock:
            pending = self.jobs.get(request_id)
        if pending is None:
            return None
        info = {"state": pending.state, "request_id": request_id}
        if pending.state == "queued":
            with self._jobs_lock:
                info["queue_position"] = sum(
                    1 for p in self.jobs.values() if p.state == "queued" and p.submit_time < pending.submit_time
                )
            info["pct"] = 0.0
        elif pending.state == "running":
            ema = self._sig_ema.get(pending.sig)
            # the first run of a signature has no estimate
            info["pct"] = min(0.95, (time.time() - pending.start_time) / ema) if ema else None
        elif pending.state == "done":
            info["pct"] = 1.0
        else:  # error
            info["pct"] = 1.0
            info["error"] = f"{type(pending.error).__name__}: {pending.error}"
        return info

    def result_png(self, request_id: str) -> Optional[_Pending]:
        with self._jobs_lock:
            return self.jobs.get(request_id)

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the batcher after the batch it is running."""
        self._shutdown = True
        self.queue.put(None)
        self.batcher.join(timeout)


def make_handler(service: SDService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "requests_served": service.requests_served,
                    "batches_run": service.batches_run,
                    "queue_depth": service.queue.qsize(),
                    "jobs_tracked": len(service.jobs),
                    "max_batch": service.cfg.serve.max_batch,
                    "samplers": list(SAMPLERS),
                    "checkpoint": service.current_checkpoint,
                    "reloads": service.reloads,
                })
            elif self.path.startswith("/progress/"):
                info = service.progress(self.path[len("/progress/"):])
                if info is None:
                    self._json(404, {"error": "unknown request_id"})
                else:
                    self._json(200, info)
            elif self.path.startswith("/result/"):
                pending = service.result_png(self.path[len("/result/"):])
                if pending is None:
                    self._json(404, {"error": "unknown request_id"})
                elif pending.state == "done":
                    self._send(200, service._to_png(pending), "image/png")
                elif pending.state == "error":
                    self._json(500, {"error": f"{type(pending.error).__name__}: {pending.error}"})
                else:  # still queued or running: 202 with the progress
                    self._json(202, service.progress(pending.id))
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/txt2img", "/txt2img_async", "/reload"):
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/reload":
                    path = service.reload(req)
                    self._json(200, {"status": "reloaded", "checkpoint": path, "reloads": service.reloads})
                    return
                if req.get("sampler", "ddim") not in SAMPLERS:
                    raise ValueError(f"unknown sampler {req.get('sampler')!r}")
                if self.path == "/txt2img_async":
                    self._json(202, {"request_id": service.submit_async(req)})
                else:
                    self._send(200, service.txt2img_png(req), "image/png")
            except Exception as e:  # noqa: BLE001 — answer with the error as JSON, keep serving
                logger.exception("request failed")
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def _add_device(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cuda; the CPU only when asked: --device cpu)")


def build_service(argv=None):
    """Parse the flags and build the service -> (service, cfg). Stops when the
    device is a card and none is present."""
    args, cfg = load_config(argv, extra_data_classes=[ServeConfig], parser_hook=_add_device)
    try:
        device = require_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"serve: {exc}") from None
    dtype = resolve_dtype(cfg.parallel.mixed_precision, device)
    return SDService(cfg, compat_from_cfg(cfg), dtype, device), cfg


def main(argv=None) -> None:
    service, cfg = build_service(argv)
    if cfg.serve.warmup:
        logger.info("warmup: the default request signature...")
        service.txt2img_png({"prompt": "warmup", "steps": cfg.serve.default_steps})
    for size in cfg.serve.warmup_sizes or []:
        logger.info(f"warmup: image_size={size}...")
        service.txt2img_png({"prompt": "warmup", "steps": cfg.serve.default_steps, "image_size": int(size)})
    server = ThreadingHTTPServer((cfg.serve.host, cfg.serve.port), make_handler(service))
    logger.info(f"serving on http://{cfg.serve.host}:{cfg.serve.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        service.stop()
        server.server_close()


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: %(message)s", level=logging.INFO)
    main()
