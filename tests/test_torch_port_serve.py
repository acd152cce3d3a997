"""The port's HTTP server on the CPU: real round trips against the in-process
server, the JAX package's ``tests/test_serve.py`` case by case (routes,
status codes, batching, byte-identical determinism, async, progress,
hot-swap), at the JAX test's tiny flags with ``--device cpu``. Plus: a
``/reload`` with a LoRA checkpoint merges it into the checkpoint's float32
weights (``lora_scale`` applied), and one whose LoRA does not fit, or is
missing, is refused with 400 before any weight changes; the swap prefers the
checkpoint's EMA weights, a checkpoint of another module is refused before
any weight changes, and ``ServeConfig`` is the JAX server's (its warm-up help
says capture where JAX's says compile).
"""

import dataclasses
import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.scripts import serve  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ARGS = [
    "--channels-list", "16,32", "--n-heads", "4", "--time-emb-dim", "32",
    "--n-layers", "1", "--autoencoder-channels-list", "8,16", "--groups", "4",
    "--noise-steps", "20", "--default-image-size", "16", "--default-steps", "3",
    "--max-batch", "4", "--batch-window-ms", "200", "--device", "cpu",
]
PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def server():
    service, _ = serve.build_service(TINY_ARGS)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield service, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    service.stop()
    thread.join(timeout=30)
    assert not thread.is_alive() and not service.batcher.is_alive()


@pytest.fixture
def server_url(server):
    return server[1]


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _health(url):
    return json.loads(_get(url + "/healthz")[2])


def test_healthz(server_url):
    body = _health(server_url)
    assert body["status"] == "ok"
    assert body["samplers"] == ["ddim", "ddpm", "dpmpp", "euler", "euler_a", "heun", "dpmpp_sde"]


def test_txt2img_returns_png_and_is_deterministic(server_url):
    status, ctype, body = _post(server_url + "/txt2img", {"prompt": "a red circle", "seed": 7})
    assert status == 200 and ctype == "image/png"
    assert body[:8] == PNG
    # same seed -> identical bytes; different seed -> different image
    assert _post(server_url + "/txt2img", {"prompt": "a red circle", "seed": 7})[2] == body
    assert _post(server_url + "/txt2img", {"prompt": "a red circle", "seed": 8})[2] != body


def test_concurrent_requests_are_batched_and_row_identical(server_url):
    """Same-signature concurrent requests fuse into one batch, and each
    request's image has its solo render's bytes (per-row seeds)."""
    seeds = [11, 12, 13, 14]
    solo = {s: _post(server_url + "/txt2img", {"prompt": "a cat", "seed": s})[2] for s in seeds}
    before = _health(server_url)
    results = {}

    def worker(s):
        results[s] = _post(server_url + "/txt2img", {"prompt": "a cat", "seed": s})[2]

    threads = [threading.Thread(target=worker, args=(s,)) for s in seeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    after = _health(server_url)
    assert after["requests_served"] - before["requests_served"] == 4
    batches = after["batches_run"] - before["batches_run"]
    assert batches < 4, f"no batching happened ({batches} batches for 4 requests)"
    for s in seeds:
        assert results[s] == solo[s], f"seed {s}: batched image != solo image"


def test_bad_sampler_is_400_json(server_url):
    status, ctype, body = _post(server_url + "/txt2img", {"prompt": "x", "sampler": "bogus"})
    assert status == 400 and ctype == "application/json"
    assert "unknown sampler" in json.loads(body)["error"]


def test_unknown_route_404(server_url):
    assert _post(server_url + "/nope", {})[0] == 404
    assert _get(server_url + "/nope")[0] == 404


def test_async_submit_progress_result(server_url):
    """/txt2img_async answers at once with an id; /progress goes queued ->
    running -> done; /result serves the PNG of the synchronous route."""
    status, _, body = _post(server_url + "/txt2img_async", {"prompt": "async cat", "seed": 3})
    assert status == 202
    rid = json.loads(body)["request_id"]
    deadline, state = time.time() + 120, None
    while time.time() < deadline:
        info = json.loads(_get(server_url + f"/progress/{rid}")[2])
        state = info["state"]
        assert state in ("queued", "running", "done")
        if state == "done":
            assert info["pct"] == 1.0
            break
        time.sleep(0.05)
    assert state == "done"
    status, ctype, body = _get(server_url + f"/result/{rid}")
    assert status == 200 and ctype == "image/png" and body[:8] == PNG
    assert _post(server_url + "/txt2img", {"prompt": "async cat", "seed": 3})[2] == body


def test_progress_unknown_id_404(server_url):
    status, _, body = _get(server_url + "/progress/nope")
    assert status == 404 and b"unknown" in body
    assert _get(server_url + "/result/nope")[0] == 404


def test_new_samplers_accepted(server_url):
    for sampler in ("ddpm", "dpmpp", "euler", "euler_a", "heun", "dpmpp_sde"):
        status, ctype, body = _post(server_url + "/txt2img",
                                    {"prompt": "euler cat", "sampler": sampler, "karras": True, "seed": 1})
        assert status == 200 and ctype == "image/png" and body[:8] == PNG, (sampler, body[:200])


def _perturbed(unet, seed, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    return {n: (p.detach().float() + scale * torch.randn(p.shape, generator=g)).to(p.dtype)
            for n, p in unet.named_parameters()}


def test_reload_hot_swaps_weights(server, tmp_path):
    """/reload swaps the UNet's weights between batches: the same request
    gives another image afterwards, with no restart; the checkpoint's EMA
    weights are the ones taken; /healthz names the checkpoint; a bad path or
    another module's checkpoint is a 400 and serving goes on unchanged."""
    service, server_url = server
    req = {"prompt": "a blue square", "seed": 11}
    before = _post(server_url + "/txt2img", req)[2]
    unet = service.model.unet
    ema = _perturbed(unet, 5)
    save_checkpoint(str(tmp_path / "swap" / "checkpoint-7"), {
        "step": 7, "params": _perturbed(unet, 6, scale=1.0), "opt_state": {}, "ema_params": ema, "epoch": None})
    status, _, body = _post(server_url + "/reload", {"unet_checkpoint": str(tmp_path / "swap")})
    assert status == 200, body
    info = json.loads(body)
    assert info["status"] == "reloaded" and info["checkpoint"].endswith("checkpoint-7")
    assert all(torch.equal(p, ema[n]) for n, p in unet.named_parameters())

    after = _post(server_url + "/txt2img", req)[2]
    assert after != before
    assert _post(server_url + "/txt2img", req)[2] == after  # deterministic under the new weights
    health = _health(server_url)
    assert health["checkpoint"].endswith("checkpoint-7") and health["reloads"] == 1

    # a bad path, and a checkpoint of another module: refused, serving goes on
    assert _post(server_url + "/reload", {"unet_checkpoint": str(tmp_path / "missing")})[0] == 400
    save_checkpoint(str(tmp_path / "vae" / "checkpoint-1"), {
        "step": 1, "params": {"conv_in.weight": torch.zeros(3)}, "opt_state": {}, "ema_params": None})
    status, _, body = _post(server_url + "/reload", {"unet_checkpoint": str(tmp_path / "vae")})
    assert status == 400 and b"does not hold this UNet" in body
    assert all(torch.equal(p, ema[n]) for n, p in unet.named_parameters())
    assert _post(server_url + "/txt2img", req)[2] == after
    assert _health(server_url)["reloads"] == 1


def test_reload_with_lora_is_refused(server, tmp_path):
    """A LoRA that does not fit the UNet, or a missing one, is a 400 JSON
    answer, and the live UNet keeps every weight."""
    service, server_url = server
    unet = service.model.unet
    live = {n: p.detach().clone() for n, p in unet.named_parameters()}
    save_checkpoint(str(tmp_path / "unet" / "checkpoint-1"), {
        "step": 1, "params": _perturbed(unet, 8), "opt_state": {}, "ema_params": None})
    name = next(n for n in live if n.endswith("self_attn.to_q.weight"))[: -len(".weight")]
    save_checkpoint(str(tmp_path / "bad_lora" / "checkpoint-1"), {
        "step": 1, "params": {f"{name}.lora_a": torch.zeros(3, 2), f"{name}.lora_b": torch.zeros(2, 3)},
        "ema_params": None})
    for lora in (tmp_path / "bad_lora", tmp_path / "missing"):
        status, ctype, body = _post(server_url + "/reload", {"unet_checkpoint": str(tmp_path / "unet"),
                                                             "lora_checkpoint": str(lora)})
        assert status == 400 and ctype == "application/json", body
        assert "error" in json.loads(body)
    assert all(torch.equal(p, live[n]) for n, p in unet.named_parameters())
    assert _post(server_url + "/reload", {})[0] == 400


def test_reload_merges_a_lora(server, tmp_path):
    """/reload with ``lora_checkpoint`` and ``lora_scale``: the live UNet
    holds the checkpoint's weights with the LoRA merged in float32, and the
    same request gives another image than the checkpoint alone."""
    from stable_diffusion_pytorch_tpu_torch.models.lora import init_lora, merge_lora

    service, server_url = server
    unet = service.model.unet
    params = _perturbed(unet, 9, scale=1.0)  # no weight at zero: an attention LoRA shows
    save_checkpoint(str(tmp_path / "unet" / "checkpoint-2"), {
        "step": 2, "params": params, "opt_state": {}, "ema_params": None})
    gen = torch.Generator().manual_seed(3)
    lora = {k: torch.randn(v.shape, generator=gen) for k, v in init_lora(params, 2, "attn", gen).items()}
    save_checkpoint(str(tmp_path / "lora" / "checkpoint-5"), {"step": 5, "params": lora, "ema_params": None})
    req = {"prompt": "a blue square", "seed": 11}
    assert _post(server_url + "/reload", {"unet_checkpoint": str(tmp_path / "unet")})[0] == 200
    plain = _post(server_url + "/txt2img", req)[2]
    status, _, body = _post(server_url + "/reload", {"unet_checkpoint": str(tmp_path / "unet"),
                                                     "lora_checkpoint": str(tmp_path / "lora"), "lora_scale": 0.5})
    assert status == 200, body
    merged = merge_lora(params, lora, 0.5)
    assert all(torch.equal(p, merged[n]) for n, p in unet.named_parameters())
    assert _post(server_url + "/txt2img", req)[2] != plain


def test_serve_config_and_buckets_are_the_jax_servers():
    spec = importlib.util.spec_from_file_location("jax_serve_script", os.path.join(REPO, "scripts", "serve.py"))
    jax_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_serve)

    def table(cls):
        return [(f.name, f.default, dict(f.metadata)) for f in dataclasses.fields(cls)]

    # the warm-up flags are JAX's; on a card they capture the sampling loop
    # where JAX's compile it, and their help says so
    expected = [(name, default, {**meta, "help": meta["help"].replace("compile", "capture")})
                for name, default, meta in table(jax_serve.ServeConfig)]
    expected[[row[0] for row in expected].index("warmup")][2]["help"] = (
        "capture the default request signature's sampling loop at startup (on a card: a warm-up run and a CUDA "
        "graph capture).")
    assert table(serve.ServeConfig) == expected
    assert [serve._bucket(n, 4) for n in range(1, 7)] == [jax_serve._bucket(n, 4) for n in range(1, 7)]
