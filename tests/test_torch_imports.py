"""The PyTorch port imports nothing of JAX: importing every module of
`invertible_cd_tpu_torch`, and `chip_smoke.py`, in a fresh interpreter
leaves `jax`, `flax`, `optax`, `orbax`, `invertible_cd_tpu` and the JAX
package's entry points (the root `cli` package) out of `sys.modules`; nor
`PIL`, which the port imports only where it reads or writes an image file
(`load_512`, the CLIs' `save_image`, the data path's `load_and_preprocess`,
the FID scorer's host resize, `utils.images.to_pil_images`)."""
import os
import pkgutil
import subprocess
import sys

import invertible_cd_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            invertible_cd_tpu_torch.__path__, prefix="invertible_cd_tpu_torch."
        )
    )


def test_port_modules_are_all_found():
    mods = set(_port_modules())
    for name in ("ops.flash_attention", "models.unet2d", "models.convert",
                 "pipelines.pipeline", "testing", "utils.tokenizer", "utils.logging",
                 "training.losses", "training.trainer", "training.checkpoint",
                 "cli.train_icd", "ops.flash_variant", "cli.exp_softmax",
                 "edit", "edit.aligner", "edit.controllers", "pipelines.loading",
                 "pipelines.sampler", "pipelines.sdxl", "pipelines.nti", "serving",
                 "data", "data.benchmarks", "utils.images", "cli.generate", "cli.edit",
                 "cli.serve", "data.dataset", "utils.native", "metrics", "metrics.resize",
                 "metrics.basic", "metrics.frechet", "metrics.inception", "metrics.fid",
                 "metrics.lpips", "metrics.vit", "metrics.image_reward", "metrics.scores",
                 "metrics.precision", "training.eval", "utils.profiling", "ops.quant",
                 "cli.quant_quality", "parallel", "parallel.mesh", "parallel.spatial",
                 "parallel.tp"):
        assert f"invertible_cd_tpu_torch.{name}" in mods


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'invertible_cd_tpu', 'cli', 'PIL'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"
