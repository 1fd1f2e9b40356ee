"""repro_torch.tune — self-driving compression (per-chunk scheme auto-tuning;
port of ``repro.tune``).

The paper frames the framework as a *testbed of comparison* between
wavelet/ZFP/SZ/FPZIP arms; this package closes that loop: the user states a
quality target (an explicit error bound — ABS, REL, or PSNR-targeted, the
vocabulary of the error-bounded-compression literature) and the framework
picks the best registered scheme **per chunk**, because the best predictor
is data-dependent *within* a single field (Tao et al. 2017).

Three layers, consumed by the ``auto`` meta-scheme
(:mod:`repro_torch.core.schemes.auto`):

* :mod:`repro_torch.tune.bound`  — :class:`Target`: parse ``abs=1e-3`` /
  ``rel=1e-4`` / ``psnr=80`` and map it onto each registered scheme's
  ``error_bound`` contract (candidate spec derivation by inverting the
  declared bound);
* :mod:`repro_torch.tune.trial`  — the trial runner: encode a deterministic
  sample of the chunk under every admissible candidate on a thread pool,
  score (achieved ratio, measured max-err/PSNR, encode time), return a
  ranked :class:`Decision`;
* :mod:`repro_torch.tune.policy` — the decision layer: by default every chunk is
  trialled (decisions are then a pure function of chunk content — the
  cluster engine's rank invariance depends on this), with an opt-in
  signature cache (``tune_cache=K`` in ``spec.extra``) that re-trials only
  every K-th chunk of a seen (range/variance/smoothness) signature.

Decisions are deterministic: candidate order, sampling, and ranking use no
randomness and no wall-clock input, so serial, threaded, and rank-parallel
encodes of the same data produce byte-identical containers.
"""
from .bound import MODES, Target, candidate_spec, target_from_spec  # noqa: F401
from .policy import DecisionPolicy, chunk_signature, policy_for  # noqa: F401
from .trial import Decision, Trial, run_trials, sample_blocks  # noqa: F401

__all__ = [
    "MODES", "Target", "candidate_spec", "target_from_spec",
    "Decision", "Trial", "run_trials", "sample_blocks",
    "DecisionPolicy", "chunk_signature", "policy_for",
]
