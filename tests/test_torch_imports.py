"""The port, chip_smoke.py and bench_torch.py import nothing of the JAX
package (not even a module of it without JAX) and none of JAX, pandas,
cv2, PIL, h5py or chex; no port module opens a file under
swiftwatcher_tpu/ (the native decoders build from the repo's
native/*.cpp); the scripts that drive the
port on the card import the port alone; and the port's synthetic video is
the JAX package's, byte for byte."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from swiftwatcher_tpu.io.synthetic import make_video as jax_make_video
from swiftwatcher_tpu_torch.io.synthetic import make_video

ROOT = Path(__file__).resolve().parent.parent
# Top-level names only: "swiftwatcher_tpu_torch" is not "swiftwatcher_tpu".
BLOCKED = ("swiftwatcher_tpu", "jax", "jaxlib", "pandas", "cv2", "PIL", "h5py", "chex")

PORT_MODULES = [
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in sorted((ROOT / "swiftwatcher_tpu_torch").rglob("*.py"))
]

_PROBE = """
import importlib, importlib.abc, os, sys
BLOCKED = set({blocked!r})
JAX_DIR = os.path.realpath({jax_dir!r}) + os.sep
opened = []

def audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        path = os.path.realpath(os.fsdecode(args[0]))
        if path.startswith(JAX_DIR):
            opened.append(path)

sys.addaudithook(audit)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, "tools")
for m in {modules!r}:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
# the host decoders build (or load) from native/*.cpp, the wire encoders
# from the port's csrc/wire_encode.cpp
from swiftwatcher_tpu_torch.io import native, native_av
native.is_available(), native_av.is_available(), native.has_symbol("swt_encode_delta6")
assert not opened, opened
print("ok", len({modules!r}))
"""

# Tools of the port that import pandas, cv2 or h5py inside their functions
# (the corpus and its scoring, the stage PNGs, the user tools, the soak, the
# campaign and measurement tools):
# imported by the probe above, and held to no JAX by
# test_port_tools_import_no_jax.
PORT_TOOLS = ["torch_accuracy_corpus", "torch_dump_stages", "torch_evaluate",
              "torch_extract_frames", "torch_export_corners", "torch_make_h5_cache",
              "torch_soak", "torch_rpca_fixed_counts", "torch_accuracy_seed_sweep",
              "torch_mesh_scaling", "torch_decode_floor", "torch_bench_rpca"]
# Entry points at the repo's root that drive the port.
ROOT_SCRIPTS = ["chip_smoke", "bench_torch"]


@pytest.mark.parametrize("modules", [
    ("models.squeezenet", "models.preprocess", "models.classifier",
     "pipeline.classify_fused", "io.segments_export"),
    ("io.native", "io.native_av", "io.parallel_decode", "io.source", "io.prefetch",
     "ops.stabilize", "pipeline.multi", "ui"),
    ("parallel.mesh", "models.train"),
    ("io.wirecodec", "io.synthetic", "io.export", "ops.rpca", "pipeline.window"),
], ids=["classify-export", "readers-flags", "mesh-train", "codec-window-corpus"])
def test_new_modules_are_checked(modules):
    """The --classify/--export modules, the readers, stabilisation,
    multi-video and picker modules, the mesh and the fine-tune, and the
    wire codec, the single-window API and the hard-scene corpus are among
    those the probe below imports with JAX, PIL, cv2 and h5py blocked:
    each imports those inside functions, or not at all."""
    for m in modules:
        assert f"swiftwatcher_tpu_torch.{m}" in PORT_MODULES


def test_port_and_chip_smoke_import_without_blocked_packages():
    modules = [m.removesuffix(".__init__") for m in PORT_MODULES] + ROOT_SCRIPTS + PORT_TOOLS
    code = _PROBE.format(blocked=BLOCKED, modules=modules,
                         jax_dir=str(ROOT / "swiftwatcher_tpu"))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"ok {len(modules)}"


def _imported_tops(path):
    """Top-level package of every import statement in a source file."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize(
    "script", ["chip_smoke.py", "tools/torch_profile.py", "tools/time_kernels.py",
               "tools/torch_parity_fuzz.py", "tools/torch_mesh_fuzz.py", "bench_torch.py",
               "tools/torch_soak.py", "tools/torch_rpca_fixed_counts.py",
               "tools/torch_accuracy_seed_sweep.py", "tools/torch_mesh_scaling.py",
               "tools/torch_decode_floor.py", "tools/torch_bench_rpca.py"]
)
def test_card_scripts_import_the_port_only(script):
    """The port keeps its own copies of the host modules it needs."""
    tops = _imported_tops(ROOT / script)
    assert not tops & set(BLOCKED), sorted(tops)
    assert "swiftwatcher_tpu_torch" in tops


@pytest.mark.parametrize("tool", PORT_TOOLS)
def test_port_tools_import_no_jax(tool):
    """The corpus and stage-dump tools of the port keep their own copies of
    the JAX-side tools' tables and scoring: no JAX, no JAX package."""
    path = ROOT / "tools" / f"{tool}.py"
    tops = _imported_tops(path)
    assert not tops & {"swiftwatcher_tpu", "jax", "jaxlib", "accuracy_corpus", "evaluate"}, tops
    assert "swiftwatcher_tpu_torch" in tops
    assert "swiftwatcher_tpu." not in path.read_text().replace("swiftwatcher_tpu_torch.", "")


def test_no_jax_in_port_sources():
    for p in (ROOT / "swiftwatcher_tpu_torch").rglob("*.py"):
        text = p.read_text()
        assert "import jax" not in text and "from jax" not in text, p
        assert "swiftwatcher_tpu." not in text.replace("swiftwatcher_tpu_torch.", ""), p
        assert "swiftwatcher_tpu" not in _imported_tops(p), p
        # no path into the JAX package's directory, as a string or a path
        # part (prose, with spaces, may name its files)
        strings = [n.value for n in ast.walk(ast.parse(text))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and not any(c.isspace() for c in n.value)]
        assert not [v for v in strings if v == "swiftwatcher_tpu"
                    or "swiftwatcher_tpu/" in v or "swiftwatcher_tpu\\" in v], p


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_frames=63, n_entering=2, n_crossing=1, n_vanishing=1),
    dict(seed=1923779129, n_frames=45, n_entering=0, n_crossing=0, n_vanishing=2,
         dot=5, brightness_drift=0.15),
    dict(seed=4, n_frames=30, H=180, W=260, n_entering=3, noise=5, amp=90),
])
def test_make_video_identical_to_jax_package(kw):
    ours, theirs = make_video(**kw), jax_make_video(**kw)
    assert ours.frames.dtype == theirs.frames.dtype == np.uint8
    np.testing.assert_array_equal(ours.frames, theirs.frames)
    assert ours.corners == theirs.corners and ours.fps == theirs.fps
    assert (ours.n_entering, ours.n_crossing, ours.n_vanishing) == (
        theirs.n_entering, theirs.n_crossing, theirs.n_vanishing)
