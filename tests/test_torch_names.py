"""Every name the reference exports resolves in the port: for each module of
``src/repro/`` with a counterpart at the same path under
``src/repro_torch/``, every name in the reference module's ``__all__`` is
an attribute of the port's module, but for the deliberate gaps below."""
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: (reference module, name) -> why the port has no such name
GAPS = {
    **{("repro.kernels.lorenzo", n): "a Pallas entry point; the port's kernel is CUDA C++"
       for n in ("lorenzo_encode_pallas", "lorenzo_decode_pallas")},
    **{("repro.kernels.zfp_transform", n): "a Pallas entry point; the port's kernel is CUDA C++"
       for n in ("zfpx_encode_pallas", "zfpx_decode_pallas")},
    ("repro.kernels.wavelet3d", "DEFAULT_TILE_BLOCKS"):
        "the Pallas grid's tile; the CUDA kernels choose their own launch shape",
    **{(m, n): "the port has no fallback, by rule: a CUDA tensor launches the kernel or raises"
       for m in ("repro.core.schemes", "repro.core.schemes._device")
       for n in ("route", "resolve_ops", "DeviceFallbackWarning")},
    ("repro.core.schemes._device", "kernel_ops"):
        "the reference's fallback test (None without Pallas); the port has no fallback, by rule",
    ("repro.core.shuffle", "zero_low_bits"): "no caller in the reference; ported with one",
    ("repro.launch.hlo_analysis", "analyze_hlo"):
        "parses XLA's HLO text; the port has none and counts its dispatched ops into the "
        "same `HloStats`",
}


def _counterparts() -> list[tuple[str, str]]:
    pairs = []
    for path in sorted(REF.rglob("*.py")):
        parts = list(path.relative_to(REF.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        port = PORT.joinpath(*parts[1:])
        if port.with_suffix(".py").exists() or (port / "__init__.py").exists():
            pairs.append((".".join(parts), ".".join(["repro_torch", *parts[1:]])))
    return pairs


PAIRS = _counterparts()


def test_the_counterparts_include_this_slice():
    names = {ref for ref, _ in PAIRS}
    for mod in ("repro.data.tokens", "repro.train.optim", "repro.train.step",
                "repro.launch.train", "repro.models.costs", "repro.kernels.ref",
                "repro.core.wavelets", "repro.core.pipeline", "repro.kernels",
                "repro.serve.step", "repro.launch.mesh", "repro.train.sharding",
                "repro.train.grad_compress", "repro.core.threshold",
                "repro.launch.dryrun", "repro.launch.hlo_analysis"):
        assert mod in names, mod


@pytest.mark.parametrize("ref,port", PAIRS, ids=[r for r, _ in PAIRS])
def test_reference_names_resolve_in_the_port(ref, port):
    want = getattr(importlib.import_module(ref), "__all__", ())
    mod = importlib.import_module(port)
    missing = [n for n in want if not hasattr(mod, n) and (ref, n) not in GAPS]
    assert not missing, f"{port} lacks {missing}"


def test_every_gap_is_still_a_gap():
    """A gap that the port has closed, or that the reference no longer
    exports, leaves the list."""
    for (ref, name), why in GAPS.items():
        assert name in getattr(importlib.import_module(ref), "__all__", ()), (ref, name)
        port = "repro_torch" + ref[len("repro"):]
        assert not hasattr(importlib.import_module(port), name), (port, name, why)


@pytest.mark.parametrize("kind", ["w4i", "w4l", "w3ai"])
def test_one_axis_lifting_step_is_the_references(kind):
    """``forward1d``/``inverse1d``: the reference's bits (its eager path)
    along each axis, and each other's inverse."""
    import numpy as np
    import torch

    from repro.core import wavelets as rw
    from repro_torch.core import wavelets as tw

    x = (np.random.default_rng(0).standard_normal((3, 8, 16, 12)) * 50).astype(np.float32)
    for axis in (-1, -2, 1):
        got = tw.forward1d(torch.from_numpy(x), kind, axis)
        want = np.asarray(rw.forward1d(x, kind, axis))
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
        back = tw.inverse1d(got, kind, axis)
        np.testing.assert_array_equal(back.numpy().view(np.int32),
                                      np.asarray(rw.inverse1d(want, kind, axis)).view(np.int32))
        np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-4 * 50)
