"""The kernel build (``repro_torch.kernels._build``) runs ``nvcc`` once per
source across processes: rank processes that load a library together wait
on one build.  Checked on the CPU, with the compiler and the loader replaced
by stubs in each process."""
import multiprocessing
import os
import time

from repro_torch.kernels import _build

NAME = "probe"


def _load_in_process(tmp: str, barrier) -> None:
    """Spawned: point the build at ``tmp``, stub the compiler (it logs and
    takes a while) and the loader, then load once all processes are ready."""
    import ctypes
    from pathlib import Path

    def slow_build(src, lib, digest):
        with open(os.path.join(tmp, "builds.log"), "a") as log:
            log.write(f"{os.getpid()}\n")
        time.sleep(1.0)
        lib.write_bytes(b"built")
        lib.with_suffix(".sha256").write_text(digest)

    _build.CSRC = Path(tmp)
    _build.BUILD_DIR = Path(tmp) / "build"
    _build._build = slow_build
    ctypes.CDLL = lambda path: path
    barrier.wait(timeout=60)
    assert _build.load(NAME) == str(_build.BUILD_DIR / f"lib{NAME}.so")


def _run(tmp: str, nprocs: int) -> list[str]:
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(nprocs)
    procs = [ctx.Process(target=_load_in_process, args=(tmp, barrier)) for _ in range(nprocs)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0] * nprocs
    with open(os.path.join(tmp, "builds.log")) as log:
        return log.read().split()


def test_processes_loading_together_build_once(tmp_path):
    (tmp_path / f"{NAME}.cu").write_text("// a source\n")
    assert len(_run(str(tmp_path), 3)) == 1
    # the library is current now: nobody builds again
    assert len(_run(str(tmp_path), 2)) == 1
    # a changed source is built again, once
    (tmp_path / f"{NAME}.cu").write_text("// another source\n")
    assert len(_run(str(tmp_path), 2)) == 2
    assert (tmp_path / "build" / f"lib{NAME}.lock").exists()
