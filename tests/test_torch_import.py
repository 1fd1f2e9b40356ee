"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and it never quietly runs on the CPU when the card is asked for."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


#: modules of the later slices, each of which must be in the import check
NEW_MODULES = ("repro_torch.obs", "repro_torch.obs.registry", "repro_torch.obs.context",
               "repro_torch.obs.events", "repro_torch.obs.trace", "repro_torch.obs.sampling",
               "repro_torch.tune", "repro_torch.tune.bound", "repro_torch.tune.trial",
               "repro_torch.tune.policy", "repro_torch.core.fpzipx",
               "repro_torch.core.schemes.fpzipx", "repro_torch.core.schemes.auto",
               "repro_torch.kernels._obs", "repro_torch.core.codec", "repro_torch.store",
               "repro_torch.store.backends", "repro_torch.store.backends.base",
               "repro_torch.store.backends.memory", "repro_torch.store.backends.file",
               "repro_torch.store.backends.object", "repro_torch.store.backends.instrument",
               "repro_torch.store.backends.retry", "repro_torch.store.backends.flaky",
               "repro_torch.store.backends.http", "repro_torch.store.manifest",
               "repro_torch.store.writer", "repro_torch.store.dataset",
               "repro_torch.cluster", "repro_torch.cluster.decompose",
               "repro_torch.cluster.engine", "repro_torch.cluster.multiwriter",
               "repro_torch.cluster._env", "repro_torch.dist", "repro_torch.dist.offsets",
               "repro_torch.dist.fault", "repro_torch.serve", "repro_torch.serve.cache",
               "repro_torch.serve.scheduler", "repro_torch.serve.region",
               "repro_torch.serve.http", "repro_torch.fields.euler3d", "repro_torch.ckpt",
               "repro_torch.ckpt.checkpoint", "repro_torch.configs", "repro_torch.configs.base",
               "repro_torch.configs.smollm_135m", "repro_torch.configs.jamba_v0_1_52b",
               "repro_torch.models", "repro_torch.models.common",
               "repro_torch.models.attention", "repro_torch.models.moe",
               "repro_torch.models.ssm", "repro_torch.models.transformer",
               "repro_torch.models.registry", "repro_torch.models.convert",
               "repro_torch.serve.step", "repro_torch.launch.serve",
               "repro_torch.kernels.ref", "repro_torch.data", "repro_torch.data.tokens",
               "repro_torch.models.costs", "repro_torch.train", "repro_torch.train.optim",
               "repro_torch.train.step", "repro_torch.launch.train",
               "repro_torch.launch.train_profile", "repro_torch.launch.dryrun",
               "repro_torch.launch.hlo_analysis")


def test_new_modules_are_in_the_import_check():
    assert set(NEW_MODULES) <= set(_port_modules())


def test_every_port_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules"
        " if sys.modules[k] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-W", "error", "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_names(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_cuda_without_a_gpu_raises(monkeypatch):
    from repro_torch.core.pipeline import CompressionSpec, Pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline(CompressionSpec(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline(CompressionSpec())  # the card is the default


def test_kernel_wrapper_runs_plain_only_on_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    never computed by the plain version."""
    from repro_torch.kernels import ops

    x = torch.empty((2, 8, 8, 8), device="meta")
    for fn in (ops.wavelet_forward, ops.wavelet_inverse, ops.zfpx_encode):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x)
    emax = torch.empty((2, 8), dtype=torch.int32, device="meta")
    q = torch.empty((2, 8, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.zfpx_decode(emax, q, n=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.lorenzo_encode(x)
    with pytest.raises(ValueError, match="CUDA"):
        ops.lorenzo_decode(torch.empty((2, 8, 8, 8), dtype=torch.int32, device="meta"))
