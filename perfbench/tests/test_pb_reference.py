"""The plain reference against files the program writes on the CPU: it
reads back the coefficients the program kept, decodes what the program
decodes, and tells a lower-precision compressor from the program."""
import numpy as np
import pytest
import torch

from perfbench.producers import cavitation, euler3d
from perfbench.reference import cz_w3ai as ref


def _field(n=64, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, n, n), generator=g).cumsum(0).cumsum(1) * 0.01 + 10.0)


def test_transform_is_the_programs_plain_version_bit_for_bit():
    from repro_torch.core import wavelets

    x = _field(32).reshape(1, 32, 32, 32).repeat(3, 1, 1, 1) * torch.tensor([1.0, -3.0, 1e-3])[:, None, None, None]
    a = wavelets.forward3d(x.clone(), "w3ai", None)
    b = ref.forward3d(x)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(wavelets.inverse3d(a, "w3ai", None).view(torch.int32),
                       ref.inverse3d(a).view(torch.int32))


def test_decoder_reads_what_the_program_wrote(tmp_path):
    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec

    f = _field()
    path = str(tmp_path / "f.cz")
    container.write_field(path, f, CompressionSpec(), workers=2, device="cpu")
    coeffs, hdr = ref.read_cz(path, "cpu")
    assert hdr["field_shape"] == [64, 64, 64] and coeffs.shape == (8, 32, 32, 32)
    j = ref.judge_field(f, coeffs, 1e-3, 100.0)
    assert j["coef_gap"] == 0.0 and j["err_bound"] < 1.0
    dec = container.read_field(path, device="cpu")
    assert np.array_equal(dec, j["decoded"].numpy())


def test_decoder_refuses_a_broken_chunk(tmp_path):
    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec

    path = tmp_path / "f.cz"
    container.write_field(str(path), _field(), CompressionSpec(), device="cpu")
    raw = bytearray(path.read_bytes())
    raw[20] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        ref.read_cz(str(path), "cpu")


def test_lower_precision_is_told_apart():
    f = _field()
    blocks = ref.blockify(f, 32)
    low = ref.kept_coeffs(blocks, 1e-3, torch.bfloat16)
    assert ref.judge_field(f, low, 1e-3, 100.0)["coef_gap"] > 1.0
    same = ref.kept_coeffs(blocks, 1e-3)
    assert ref.judge_field(f, same, 1e-3, 100.0)["coef_gap"] == 0.0


def test_producers_are_the_repositorys_fields():
    from repro_torch.fields import cavitation as pc
    from repro_torch.fields import euler3d as pe

    # the Euler state: the Table 1 cloud (every bubble on the full grid,
    # combined by maximum) placed by the seed; the step is the repository's
    cloud = {"n_bubbles": 70, "cloud_radius": 0.35, "r_mean": 0.035, "r_sigma": 0.35,
             "cloud_seed": 1234}
    U = euler3d.init_bubble_cloud(32, cloud, 0, "cpu", p_ambient=100.0, p_bubble=49.0,
                                  rho_liquid=1000.0, rho_gas=16.0)
    centers, radii = cavitation.bubble_cloud(70, 0.35, 0.035, 0.35, 1234)
    ax = (np.arange(32) + 0.5) / 32
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    chi = np.zeros((32, 32, 32))
    for c, r in zip(centers.astype(np.float64), radii.astype(np.float64)):
        d = np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
        chi = np.maximum(chi, 0.5 * (1 - np.tanh((d - r) / (1.5 / 32))))
    rng = np.random.default_rng(0)  # the placement seed 0 draws
    order, shift = [int(a) for a in rng.permutation(3)], [int(v) for v in rng.integers(0, 32, 3)]
    chi = np.roll(chi.transpose(order), shift, axis=(0, 1, 2))
    assert chi.max() > 0.9 and chi.min() < 1e-9
    assert np.allclose(U[0].numpy(), 1000.0 * (1 - chi) + 16.0 * chi, rtol=1e-6, atol=0)
    assert np.allclose(U[4].numpy() * 0.4, 100.0 * (1 - chi) + 49.0 * chi, rtol=1e-6, atol=0)
    assert not U[1:4].any()
    dt = euler3d.cfl_dt(U, 0.35)
    assert torch.equal(euler3d.step(U, dt), pe.step(U, dt))
    # the cloud: the same bubbles; the background noise is the seed's own
    cfg = pc.CloudConfig(n=32)
    mine = cavitation.cavitation_fields({"n": 32, "n_bubbles": 70, "cloud_radius": 0.35,
                                         "r_mean": 0.035, "r_sigma": 0.35, "cloud_seed": 1234,
                                         "gamma": 1.4, "p_ambient": 100.0, "p_min": 49.0,
                                         "rho_liquid": 1000.0, "rho_gas": 16.0,
                                         "sound_speed": 0.12, "shock_amp": 1500.0},
                                        9.4, 5, "cpu")
    theirs = pc.cavitation_fields(cfg, 9.4, "cpu")
    assert torch.equal(mine["a2"], theirs["a2"])
    assert torch.allclose(mine["p"], theirs["p"], rtol=1e-4)
