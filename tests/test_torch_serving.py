"""The port's serving layer (`serving.BatchingExecutor`, `cli/serve.py`) on
the CPU, the twin of `tests/test_serving.py` without the mesh tests.

The bundle is the port's tiny SD1.5 bundle built through the weights bridge
from the JAX tiny bundle's numpy-seeded params, so that one test can hold
the served images to JAX's `generate` on the same latents (the port's
`_latents`, handed to JAX as numpy) at the pipeline tolerance, atol 1e-4 /
rtol 1e-3 (fp32). The rest is the executor's contract: a request's image
is a function of its prompt and seed and of the batch's size, which the
tests hold bit for bit against direct `generate` calls at the same size.
"""
import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from invertible_cd_tpu import models as jmodels
from invertible_cd_tpu.pipelines.pipeline import InvertibleCD as JInvertibleCD
from invertible_cd_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from invertible_cd_tpu_torch.cli.serve import make_server, parse_args
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.pipelines.pipeline import to_uint8
from invertible_cd_tpu_torch.serving import BatchingExecutor, latent_seed
from invertible_cd_tpu_torch.testing import tiny_bundle, tiny_bundle_xl

from _torch_jax_params import seeded_params

ATOL, RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's tiny models (see
    `test_torch_baselines.py`): under the suite's parallel workers more
    threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jpipe():
    """The JAX tiny SD1.5 bundle with numpy-seeded weights (as in
    `test_torch_baselines.py`: traced init shapes, no Flax init)."""
    unet_cfg, clip_cfg = jmodels.UNetConfig.tiny(), jmodels.CLIPTextConfig.tiny()
    pipe = JInvertibleCD.sd15(dtype=jnp.float32, unet_cfg=unet_cfg, clip_cfg=clip_cfg,
                              vae_cfg=jmodels.VAEConfig.tiny(), latent_size=(16, 16),
                              tokenizer=JHashTokenizer(clip_cfg.vocab_size))
    return dataclasses.replace(pipe, params=seeded_params(pipe.params))


@pytest.fixture(scope="module")
def pipe(jpipe):
    return tiny_bundle(convert.bundle_state_dicts_from_flax(jax.tree.map(np.asarray, jpipe.params)))


def _direct(pipe, ex, prompts, seeds):
    """`pipe.generate` on the executor's latents for `seeds`, as numpy."""
    images, _ = pipe.generate(prompts, latent=ex._latents(seeds), guidance=ex.guidance)
    return images.numpy()


# ---------------------------------------------------------------------------
# BatchingExecutor
# ---------------------------------------------------------------------------
def test_batch_invariance_and_padding(pipe):
    """A lone request rides a batch padded with its own repeats; its image
    is row 0 of a direct call at that size, bit for bit."""
    with BatchingExecutor(pipe, batch_size=4, max_delay=0.5) as ex:
        img = ex.generate("a red fox", seed=11)
        stats = ex.stats()
        want = _direct(pipe, ex, ["a red fox"] * 4, [11] * 4)
    assert stats["batches"] == 1 and stats["padded_slots"] == 3 and stats["batches_b4"] == 1
    assert img.shape == (32, 32, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, want[0])


def test_coalescing(pipe):
    with BatchingExecutor(pipe, batch_size=4, max_delay=1.0) as ex:
        ex.generate("warmup", seed=0)
        futs = [ex.submit(f"prompt variant {i}", seed=i) for i in range(4)]
        imgs = [f.result(timeout=300) for f in futs]
        stats = ex.stats()
        want = _direct(pipe, ex, [f"prompt variant {i}" for i in range(4)], list(range(4)))
    assert all(np.isfinite(i).all() for i in imgs)
    # the worker soaks max_delay = 1 s for stragglers: one batch of 4
    assert stats["batches"] == 2 and stats["padded_slots"] == 3
    for got, row in zip(imgs, want):
        np.testing.assert_array_equal(got, row)
    assert np.abs(imgs[0] - imgs[1]).max() > 0  # distinct seeds, distinct images


def test_seeds_large_distinct_and_reproducible(pipe):
    """Seeds that differ only above bit 31 draw different latents (the CPU
    generator keys on 32 bits: `latent_seed` mixes all 64 in), the int64
    extremes are served, and a seed gives the same image again."""
    big = 2**40 + 123
    assert latent_seed(big) != latent_seed(big + 2**32)
    assert latent_seed(-1) == latent_seed(2**64 - 1)  # the seed as uint64
    with BatchingExecutor(pipe, batch_size=2, max_delay=0.05) as ex:
        a = ex.generate("hi-bit seed", seed=big)
        b = ex.generate("hi-bit seed", seed=big + 2**32)
        a2 = ex.generate("hi-bit seed", seed=big)
        lo, hi = ex.generate("edge", seed=-(2**63)), ex.generate("edge", seed=2**63 - 1)
        lat = ex._latents([big, big + 2**32, -(2**63), 2**63 - 1])
    assert np.abs(a - b).max() > 0, "high seed bits were dropped"
    np.testing.assert_array_equal(a, a2)
    assert np.isfinite(lo).all() and np.isfinite(hi).all() and np.abs(lo - hi).max() > 0
    assert tuple(lat.shape) == (4, 16, 16, 4) and lat.dtype == torch.float32
    assert len({row.numpy().tobytes() for row in lat}) == 4


def test_tiny_xl_bundle_serves():
    """The executor is pipeline-agnostic: SDXL's added conditioning rides
    inside generate()."""
    xl = tiny_bundle_xl(None)
    with BatchingExecutor(xl, batch_size=2, max_delay=0.05) as ex:
        img = ex.generate("an sdxl prompt", seed=3)
        want = _direct(xl, ex, ["an sdxl prompt"] * 2, [3, 3])
    np.testing.assert_array_equal(img, want[0])


def test_out_of_range_seed_rejected_at_submit(pipe):
    with BatchingExecutor(pipe, batch_size=2, max_delay=0.3) as ex:
        with pytest.raises(ValueError, match="int64"):
            ex.submit("x", seed=2**63)
        with pytest.raises(ValueError, match="int64"):
            ex.submit("x", seed=-(2**63) - 1)
        img = ex.generate("a fine request", seed=1)  # neighbours are unaffected
    assert np.isfinite(img).all()


def test_cancelled_future_does_not_poison_batch(pipe):
    with BatchingExecutor(pipe, batch_size=2, max_delay=0.5) as ex:
        f1 = ex.submit("to be cancelled", seed=1)
        cancelled = f1.cancel()
        f2 = ex.submit("still wants an image", seed=2)
        img = f2.result(timeout=300)
    assert cancelled and np.isfinite(img).all()


def test_submit_after_shutdown_raises(pipe):
    ex = BatchingExecutor(pipe, batch_size=2)
    ex.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit("too late")


def test_worker_failure_propagates_to_futures(pipe):
    ex = BatchingExecutor(pipe, batch_size=2, max_delay=0.05)
    try:
        ex.pipe = type(ex.pipe)  # not a pipeline: the latents or generate blow up
        fut = ex.submit("boom")
        with pytest.raises(Exception):
            fut.result(timeout=60)
    finally:
        ex.shutdown()


def test_single_request_small_batch_burst_large_batch(pipe):
    """batch_sizes=(1, 4): a lone request runs at batch 1, unpadded; a burst
    of four at batch 4. Across the two sizes the same request's image may
    differ in rounding only."""
    with BatchingExecutor(pipe, batch_sizes=(1, 4), max_delay=0.5) as ex:
        img = ex.generate("a red fox", seed=11)
        stats1 = ex.stats()
        futs = [ex.submit(f"prompt {i}", seed=i) for i in range(3)]
        futs.append(ex.submit("a red fox", seed=11))
        burst = [f.result(timeout=300) for f in futs]
        stats = ex.stats()
        want1 = _direct(pipe, ex, ["a red fox"], [11])
    assert stats1["batches_b1"] == 1 and stats1["padded_slots"] == 0
    assert stats["batches_b4"] == 1 and stats["padded_slots"] == 0
    np.testing.assert_array_equal(img, want1[0])
    np.testing.assert_allclose(burst[3], img, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sizes", [(0, 4), (-1,)])
def test_invalid_sizes_rejected(pipe, sizes):
    with pytest.raises(ValueError):
        BatchingExecutor(pipe, batch_sizes=sizes)


def test_expired_request_fails_with_timeout(pipe):
    """A request whose dispatch deadline passed while queued gets
    TimeoutError, not device time; requests without a deadline never
    expire."""
    with BatchingExecutor(pipe, batch_size=2, max_delay=0.01) as ex:
        first = ex.submit("warm", seed=0)
        expired = ex.submit("too late", seed=1, timeout=-1.0)
        first.result()
        with pytest.raises(TimeoutError):
            expired.result(timeout=30)
        assert ex.generate("after", seed=2).shape == (32, 32, 3)
        assert ex.generate("no deadline", seed=3).shape == (32, 32, 3)
        assert ex.stats()["expired"] == 1


class _WedgedImages:
    """Stands in for a batch's images whose copy to the host never ends
    until `release` is set."""

    is_cuda = False

    def __init__(self, release: threading.Event, n: int):
        self.release, self.n = release, n

    def __getitem__(self, index):
        return self

    def numpy(self):
        self.release.wait(30)
        return np.zeros((self.n, 2, 2, 3), np.float32)


class _WedgingPipe:
    latent_size = (2, 2)
    device = torch.device("cpu")

    def __init__(self):
        self.release = threading.Event()

    def default_guidance(self):
        return None

    def generate(self, prompts, **kw):
        return _WedgedImages(self.release, len(prompts)), None


def test_shutdown_returns_while_the_completer_is_wedged():
    """With the completion thread stuck in a copy and the batches behind it
    waiting, shutdown returns after its timeout instead of hanging: the
    worker stops, every batch not yet copied fails, and the completion
    thread ends once its copy does."""
    wedge = _WedgingPipe()
    ex = BatchingExecutor(wedge, batch_size=1, max_delay=0.0)
    futs = [ex.submit(f"r{i}", seed=i) for i in range(4)]
    deadline = time.monotonic() + 10
    while ex._completion.qsize() < 2 and time.monotonic() < deadline:  # two batches wait
        time.sleep(0.01)
    time.sleep(0.2)  # the fourth batch now waits for a slot
    t0 = time.monotonic()
    ex.shutdown(timeout=0.5)
    assert time.monotonic() - t0 < 5
    ex._worker.join(5)
    assert not ex._worker.is_alive()
    for fut in futs[1:]:
        with pytest.raises(RuntimeError, match="shut down"):
            fut.result(timeout=5)
    assert not futs[0].done()
    wedge.release.set()
    assert futs[0].result(timeout=5).shape == (2, 2, 3)
    ex._completer.join(5)
    assert not ex._completer.is_alive()


def test_served_images_match_jax(pipe, jpipe):
    """Four requests served in one batch against JAX's generate on the
    same latents (the port's, as numpy), fp32."""
    prompts = ["a photo of a cat", "a red fox", "a lighthouse at dusk", "a bowl of ramen"]
    seeds = [7, -(2**63), 2**63 - 1, 123456789]
    with BatchingExecutor(pipe, batch_size=4, max_delay=1.0) as ex:
        futs = [ex.submit(p, seed=s) for p, s in zip(prompts, seeds)]
        got = np.stack([f.result(timeout=300) for f in futs])
        latents = ex._latents(seeds).numpy()
        assert ex.stats()["batches_b4"] == 1
    want, _ = jpipe.generate(prompts, latent=jnp.asarray(latents), guidance=jpipe.default_guidance())
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------
@pytest.fixture()
def server(pipe):
    args = parse_args(["--model", "tiny", "--device", "cpu", "--port", "0", "--batch_size", "2",
                       "--max_delay_ms", "20"])
    srv, ex = make_server(args, pipe=pipe)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    ex.shutdown()
    srv.server_close()
    t.join(10)


def _post(port, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body, method="POST")
    return urllib.request.urlopen(req, timeout=300)


def test_generate_and_healthz(server):
    """The PNG decodes to `to_uint8` of the executor's image for the seed;
    /healthz reports the executor's stats."""
    port = server.server_address[1]
    with _post(port, json.dumps({"prompt": "a cat", "seed": 5}).encode()) as r:
        body = r.read()
        assert r.headers["Content-Type"] == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    got = np.asarray(Image.open(io.BytesIO(body)))
    want = server.executor.generate("a cat", seed=5)
    np.testing.assert_array_equal(got, to_uint8(want))
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["requests"] == 2 and health["batches"] == 2


@pytest.mark.parametrize(
    "body",
    [b"{not json", b'["a cat"]', b'"a cat"', b'{"prompt": 5}',
     b'{"prompt": "a cat", "seed": "x"}',
     b'{"prompt": "a cat", "seed": 1208925819614629174706176}'],
)
def test_bad_request_400(server, body):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server.server_address[1], body)
    assert err.value.code == 400


def test_failed_request_500(server, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("the device is on fire")
    monkeypatch.setattr(server.executor, "pipe", type("P", (), {"latent_size": (16, 16),
                                                               "device": torch.device("cpu"),
                                                               "generate": boom})())
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server.server_address[1], b'{"prompt": "a cat"}')
    assert err.value.code == 500 and b"on fire" in err.value.read()
