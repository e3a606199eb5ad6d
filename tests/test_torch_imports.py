"""The port stands alone: no JAX, nothing of hexl_tpu, the card by default.

Also: the build refuses to go on quietly when nvcc fails or is missing.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hexl_tpu_torch import FFTLike

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "hexl_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "example_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "hexl_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_hexl_tpu_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_import_leaves_jax_out():
    code = ("import sys, hexl_tpu_torch, hexl_tpu_torch.poly, "
            "hexl_tpu_torch.config, hexl_tpu_torch.ntt.chain, "
            "hexl_tpu_torch.experimental.df_chain; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hexl_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_points_default_to_cuda():
    from hexl_tpu_torch import NTT, eltwise_mult_mod, nt, poly_mult_mod
    q = nt.generate_primes(1, 50, True, ntt_size=16)[0]
    x = np.ones(16, dtype=np.uint64)
    if torch.cuda.is_available():
        assert NTT(16, q).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        NTT(16, q)
    with pytest.raises(RuntimeError, match="CUDA"):
        NTT(16, q, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        eltwise_mult_mod(x, x, q)
    with pytest.raises(RuntimeError, match="CUDA"):
        poly_mult_mod(x, x, 16, q)


def test_slice3_entry_points_default_to_cuda():
    """Every entry point of the eltwise family and of the composites
    runs on CUDA unless given device="cpu", and raises without a card."""
    import hexl_tpu_torch as port
    q = port.nt.generate_primes(3, 50, True, ntt_size=16)
    x = np.ones(16, dtype=np.uint64)
    c = np.ones((2, 2, 16), dtype=np.uint64)
    keys = np.ones((2, 2, 3, 16), dtype=np.uint64)
    calls = [
        (port.eltwise_add_mod, (x, x, q[0])),
        (port.eltwise_add_mod, (x, 3, q[0])),
        (port.eltwise_sub_mod, (x, x, q[0])),
        (port.eltwise_sub_mod, (x, 3, q[0])),
        (port.eltwise_mult_mod, (x, x, q[0])),
        (port.eltwise_fma_mod, (x, 3, x, q[0])),
        (port.eltwise_fma_mod, (x, 3, None, q[0])),
        (port.eltwise_reduce_mod, (x, q[0], 2, 1)),
        (port.eltwise_cmp_add, (x, "lt", 5, 1)),
        (port.eltwise_cmp_sub_mod, (x, q[0], "lt", 5, 1)),
        (port.eltwise_montgomery_form_in, (x, q[0])),
        (port.eltwise_montgomery_form_out, (x, q[0])),
        (port.eltwise_montgomery_mult_reduce, (x, x, q[0])),
        (port.dyadic_multiply, (c, c, q[:2])),
        (port.lr_mat_vec_mult, (c[None], c[None], q[:2])),
        (port.key_switch, (c, c[0], 16, 2, 3, 3, 2, q, keys, [1, 1])),
    ]
    for fn, args in calls:
        if torch.cuda.is_available():
            assert fn(*args).shape    # runs on the card
            continue
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args)
        assert isinstance(fn(*args, device="cpu"), np.ndarray)


def test_slice4_entry_points_default_to_cuda():
    """FFTLike in every precision, its device compose and the MXU
    transforms run on CUDA unless given device="cpu", and raise without a
    card."""
    import hexl_tpu_torch as port
    from hexl_tpu_torch.ntt import fwd_ntt_mxu, get_mxu_plan, inv_ntt_mxu
    q = port.nt.generate_primes(1, 50, True, ntt_size=256)[0]
    plan = get_mxu_plan(256, q)
    x = np.ones((1, 256), dtype=np.uint64)
    z = np.ones(16, dtype=np.complex128)
    words = np.ones((2, 16), dtype=np.uint64)
    for precision in ("auto", "f64", "single", "double_float"):
        if torch.cuda.is_available():
            assert FFTLike(16, precision=precision).device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="CUDA"):
            FFTLike(16, precision=precision)
        fft = FFTLike(16, 2.0, precision=precision, device="cpu")
        assert isinstance(fft.forward(z), np.ndarray)
        assert isinstance(fft.inverse(z), np.ndarray)
    if torch.cuda.is_available():
        assert fwd_ntt_mxu(x, plan).shape == x.shape
        return
    for fn in (fwd_ntt_mxu, inv_ntt_mxu):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(x, plan)
        assert isinstance(fn(x, plan, device="cpu"), np.ndarray)
    dev = FFTLike(16, device="cpu").build_floating_points_device(
        words, [0, 1], [1, 2], 1.0)
    assert dev.hi.device.type == "cpu"


def test_failed_build_raises(tmp_path, monkeypatch):
    from hexl_tpu_torch import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_failed_launch_raises_and_is_not_counted():
    from hexl_tpu_torch import _build
    before = dict(_build.launches)
    with pytest.raises(RuntimeError, match="cudaError 2"):
        _build.launch("K9", lambda *args: 2)
    assert dict(_build.launches) == before
    _build.launch("K9", lambda *args: 0)
    assert _build.launches["K9"] == before.get("K9", 0) + 1


def test_build_dir_is_keyed_on_the_sources(tmp_path, monkeypatch):
    from hexl_tpu_torch import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one\n")
    (csrc / "u.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.build_dir()
    assert first == _build.build_dir()
    (csrc / "u.cuh").write_text("// header, changed\n")
    assert _build.build_dir() != first
    assert _build.build_dir().parent == _build.BUILD_ROOT


def test_slice5_entry_points_default_to_cuda():
    """The parallel layer is in the package (and under the import guard
    above), and a mesh with devices=None wants one card per position: it
    raises without them and never lays positions over fewer cards or the
    CPU by itself."""
    from hexl_tpu_torch.parallel import make_mesh, make_pipeline_mesh
    assert any(p.parent.name == "parallel" for p in PORT_FILES)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for make, count in ((lambda: make_mesh(2, 2), 4),
                        (lambda: make_mesh(cards + 1), cards + 1),
                        (lambda: make_pipeline_mesh(cards + 1), cards + 1)):
        if cards >= count:
            assert {d.type for d in make().devices.flat} == {"cuda"}
            continue
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2, 1, ["cuda:0"] * 2)
    assert make_mesh(4, 2, ["cpu"] * 8).shape == {"batch": 2, "coeff": 4}


def test_kernel_resources_parses_the_ptxas_report():
    """The `-Xptxas -v` report that chip_smoke.py and the GPU tests read
    for registers and spills."""
    from hexl_tpu_torch import _build
    log = (
        "ptxas info    : Compiling entry function '_Z3abcv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3abcv\n"
        "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 254 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_Z3defv' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers\n")
    assert _build.kernel_resources(log) == {
        "_Z3abcv": (254, 16, 8, 4), "_Z3defv": (40, None, None, None)}


def test_host_library_is_the_ports_own(tmp_path, monkeypatch):
    """The host library is built from the port's `csrc/host.cpp`; nothing
    of the port opens the JAX package's `csrc/hexl_tpu_host.cpp`."""
    from hexl_tpu_torch import _build
    src = ROOT / "hexl_tpu_torch" / "csrc" / "host.cpp"
    assert src.is_file() and _build.CSRC / "host.cpp" == src
    for path in PORT_FILES:
        assert "hexl_tpu_host" not in path.read_text(), path
    commands = []
    run = subprocess.run

    def spy(cmd, **kwargs):
        commands.append(cmd)
        return run(cmd, **kwargs)

    monkeypatch.setattr(_build.subprocess, "run", spy)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    lib = _build.build_host()
    assert [cmd[-1] for cmd in commands] == [str(src)]
    assert lib.is_file() and lib.parent.parent == tmp_path / "build"


def test_version_is_the_jax_packages():
    """The port carries a copy of the JAX package's version (it imports
    nothing of that package)."""
    import hexl_tpu
    import hexl_tpu_torch
    assert hexl_tpu_torch.__version__ == hexl_tpu.__version__


def test_get_rns_plan_takes_a_device():
    """get_rns_plan(degree, moduli, device), as in the JAX package: each
    prime's tables are copied to the device."""
    from hexl_tpu_torch import get_rns_plan, nt
    moduli = nt.generate_primes(2, 50, True, ntt_size=64)
    rplan = get_rns_plan(64, moduli, "cpu")
    assert rplan.moduli == tuple(moduli) and rplan.n == 64
    for plan in rplan.plans:
        assert "cpu" in plan._dev
        assert plan.tables("cpu")["rop"].device.type == "cpu"
