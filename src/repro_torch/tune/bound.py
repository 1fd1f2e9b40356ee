"""Error-bound targets and their mapping onto scheme ``error_bound`` contracts
(port of ``repro.tune.bound``; only the package path differs).

Users of error-bounded compressors think in bounds, not codec names: an
absolute tolerance, a value-range-relative tolerance, or a PSNR floor.
:class:`Target` is that vocabulary —

* ``abs=V``  — max absolute error ``<= V`` everywhere;
* ``rel=V``  — max absolute error ``<= V * (chunk value range)``; the range
  is evaluated **per chunk**, so smooth quiet regions get proportionally
  tighter bounds than energetic ones (and the decision stays a pure
  function of chunk content — rank-invariant);
* ``psnr=DB`` — target PSNR (paper Eq. 1) of at least ``DB``; mapped to an
  absolute bound per chunk via the uniform-quantization error model
  (``rmse ~ a / sqrt(3)`` for a bound ``a``), then enforced against the
  *measured* trial PSNR, so the mapping is a search seed, not a promise
  made blind.

:func:`candidate_spec` inverts a registered scheme's declared
``error_bound`` contract (every in-tree lossy scheme declares a bound
linear in ``eps``) to derive the candidate eps that meets a chunk's
absolute bound; lossless schemes are always admissible.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.pipeline import CompressionSpec
from repro_torch.core.schemes import get_scheme

__all__ = ["MODES", "Target", "target_from_spec", "candidate_spec"]

MODES = ("abs", "rel", "psnr")

#: relative slack when re-checking an inverted eps against the declared
#: bound — absorbs float rounding of the inversion, nothing more
_INVERT_SLACK = 1e-9


@dataclasses.dataclass(frozen=True)
class Target:
    """One user-facing quality target: a mode (see :data:`MODES`) + value."""

    mode: str
    value: float

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown target mode {self.mode!r}; one of {MODES}")
        v = float(self.value)
        if not math.isfinite(v) or v <= 0:
            raise ValueError(
                f"target {self.mode}={self.value!r} must be a finite "
                "positive number")
        object.__setattr__(self, "value", v)

    def __str__(self) -> str:
        return f"{self.mode}={self.value:g}"

    @staticmethod
    def parse(text: str) -> "Target":
        """Parse ``"abs=1e-3" | "rel=1e-4" | "psnr=80"`` (the CLI/extra
        syntax).  Raises ValueError on anything else."""
        mode, sep, val = str(text).partition("=")
        if not sep:
            raise ValueError(
                f"bad target {text!r}: expected MODE=VALUE with MODE one "
                f"of {MODES} (e.g. psnr=80, abs=1e-3, rel=1e-4)")
        try:
            value = float(val)
        except ValueError:
            raise ValueError(
                f"bad target value {val!r} in {text!r}: not a number"
            ) from None
        return Target(mode.strip(), value)

    def abs_bound(self, vmin: float, vmax: float) -> float:
        """The absolute error bound this target implies for data spanning
        ``[vmin, vmax]`` (a chunk's value range).  ``rel``/``psnr`` targets
        collapse to 0 for constant data — only lossless candidates remain
        admissible there."""
        if self.mode == "abs":
            return self.value
        rng = float(vmax) - float(vmin)
        if self.mode == "rel":
            return self.value * rng
        # psnr (paper Eq. 1): 20*log10(rng / (2*rmse)) >= DB, with the
        # uniform-error model rmse ~ a/sqrt(3) for a max-abs bound a
        return rng * math.sqrt(3.0) / (2.0 * 10.0 ** (self.value / 20.0))


def target_from_spec(spec: CompressionSpec) -> Target:
    """The spec's target: ``spec.extra["target"]`` when set, else the
    spec's own ``eps`` read as an absolute bound — so ``auto`` behaves as
    an eps-parameterized scheme anywhere a plain spec is expected."""
    raw = spec.extra.get("target") if spec.extra else None
    if raw is None:
        return Target("abs", spec.eps)
    if isinstance(raw, Target):
        return raw
    return Target.parse(raw)


def candidate_spec(name: str, spec: CompressionSpec,
                   abs_bound: float) -> CompressionSpec | None:
    """A candidate spec for scheme ``name`` meeting ``abs_bound``, derived
    from ``spec`` (everything but scheme/eps is inherited — shuffle,
    stage2, block size, dtype, device), or ``None`` when the scheme cannot
    promise the bound:

    * lossless schemes (declared bound ``None``) are always admissible;
    * lossy schemes with a finite declared bound linear in eps get
      ``eps = abs_bound / bound(eps=1)`` (re-checked, not assumed);
    * unbounded-lossy configurations and specs the scheme's own
      ``validate`` rejects are dropped.
    """
    cand = dataclasses.replace(spec, scheme=name, extra={})
    sch = get_scheme(name)
    try:
        b1 = sch.error_bound(dataclasses.replace(cand, eps=1.0))
        if b1 is not None:
            if not (math.isfinite(b1) and b1 > 0 and abs_bound > 0):
                return None
            eps = abs_bound / b1
            cand = dataclasses.replace(cand, eps=eps)
            bound = sch.error_bound(cand)
            if bound is None or bound > abs_bound * (1 + _INVERT_SLACK):
                return None  # the scheme's bound is not linear in eps
        cand.validate()
    except ValueError:
        return None  # scheme rejects this combination by contract
    return cand
