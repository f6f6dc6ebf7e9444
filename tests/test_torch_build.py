"""The port's kernel build (swiftwatcher_tpu_torch/build.py) without nvcc:
which sources it knows, which of them `build_all` builds, and that a build
with preprocessor defines (tools/time_kernels.py --t1-split) is a library
of its own.  Building and launching the kernels needs the card
(chip_smoke.py)."""

import pytest

from swiftwatcher_tpu_torch import build


def test_build_all_builds_the_ports_kernels_and_not_the_tools(monkeypatch):
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(build._SIGNATURES)
    built = []
    monkeypatch.setattr(build, "load_library", built.append)
    build.build_all()
    assert sorted(built) == sorted(build.KERNEL_SOURCES)
    assert not set(built) & set(build.TOOL_SOURCES) and build.TOOL_SOURCES
    built.clear()
    build.build_all(build.TOOL_SOURCES)
    assert built == list(build.TOOL_SOURCES)


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_each_source_and_its_defines_key_their_own_library(name):
    assert (build.CSRC / f"{name}.cu").is_file()
    assert (name in build.KERNEL_SOURCES) != (name in build.TOOL_SOURCES)
    plain = build._library_path(name)
    assert plain.parent == build.BUILD_DIR and plain.name.startswith(f"lib{name}-")
    assert build._library_path(name, ()) == plain
    split = build._library_path(name, ("T1_SPLIT",))
    assert split != plain and split.parent == build.BUILD_DIR
    assert build._library_path(name, ("T1_SPLIT",)) == split
    others = {build._library_path(n) for n in build._SIGNATURES if n != name}
    assert plain not in others
