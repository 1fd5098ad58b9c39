"""The kernel library's build (``typeagent_tpu_torch/ops/_build.py``):
compile units with flags of their own, ``topk.cu`` in four parts, and the
build started in the background by a store made on a CUDA device. No
compiler runs here: the commands are recorded, not run."""

from __future__ import annotations

import os
import re
import threading

import pytest
import torch

from typeagent_tpu_torch.ops import _build

TOPK = os.path.join(_build.CSRC_DIR, "topk.cu")


@pytest.fixture
def recorded(tmp_path, monkeypatch):
    """``build_shared`` into ``tmp_path`` with ``_run_all`` recording each
    batch of commands and touching the files they would write."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    batches = []

    def fake_run_all(commands, what):
        batches.append(commands)
        for cmd in commands:
            with open(cmd[cmd.index("-o") + 1], "wb") as f:
                f.write(b"")

    monkeypatch.setattr(_build, "_run_all", fake_run_all)
    return batches


def _sources(tmp_path, n):
    paths = []
    for i in range(n):
        path = tmp_path / f"s{i}.cu"
        path.write_text(f"// source {i}\n")
        paths.append(str(path))
    return paths


def test_one_plain_source_compiles_and_links_in_one_command(recorded, tmp_path):
    (src,) = _sources(tmp_path, 1)
    out = _build.build_shared("lib", [src], [], ["cc", "-shared"])
    assert os.path.exists(out)
    assert len(recorded) == 1 and len(recorded[0]) == 1
    cmd = recorded[0][0]
    assert cmd[:2] == ["cc", "-shared"] and cmd[-1] == src and "-c" not in cmd


@pytest.mark.parametrize("flags", [(), ("-DPART=2",), ("-DA=1", "-DB=2")])
def test_one_unit_with_flags_compiles_them(recorded, tmp_path, flags):
    (src,) = _sources(tmp_path, 1)
    _build.build_shared("lib", [(src, flags)], [], ["cc", "-shared"])
    (cmd,) = recorded[0]
    assert cmd == ["cc", "-shared", *flags, "-o", cmd[cmd.index("-o") + 1], src]


def test_units_compile_at_once_each_with_its_flags_then_link(recorded, tmp_path):
    a, b = _sources(tmp_path, 2)
    units = [(a, ("-DP=0",)), (a, ("-DP=1",)), b]
    _build.build_shared("lib", units, [], ["cc", "-O3", "-shared"])
    compiles, links = recorded
    assert len(compiles) == 3 and len(links) == 1
    for cmd, (src, flags) in zip(compiles, [(a, ["-DP=0"]), (a, ["-DP=1"]), (b, [])]):
        assert "-shared" not in cmd and cmd[0:2] == ["cc", "-O3"]
        assert cmd[2 : 2 + len(flags)] == flags and "-c" in cmd and cmd[-1] == src
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert len(set(objects)) == 3
    assert links[0][-3:] == objects and links[0][:3] == ["cc", "-O3", "-shared"]


def test_a_unit_flag_is_part_of_the_library_name(recorded, tmp_path):
    (src,) = _sources(tmp_path, 1)
    plain = _build.build_shared("lib", [src], [], ["cc"])
    flagged = _build.build_shared("lib", [(src, ("-DX=1",))], [], ["cc"])
    other = _build.build_shared("lib", [(src, ("-DX=2",))], [], ["cc"])
    assert len({plain, flagged, other}) == 3
    assert _build.build_shared("lib", [(src, ("-DX=1",))], [], ["cc"]) == flagged
    assert len(recorded) == 3  # the fourth call found its library built


def test_kernel_units_cover_every_source_and_topk_in_four_parts():
    by_source = {}
    for source, flags in _build.KERNEL_UNITS:
        by_source.setdefault(source, []).append(flags)
    assert sorted(by_source) == sorted(_build.KERNEL_SOURCES)
    assert by_source["topk.cu"] == [(f"-DTOPK_PART={p}",) for p in range(4)]
    for source in _build.KERNEL_SOURCES[1:]:
        assert by_source[source] == [()]


def _topk_parts():
    """``{part: [entry point names]}`` of ``topk.cu`` and the parts that
    define the merge kernel, read from its ``#if TOPK_IN_PART(n)``
    blocks."""
    entries, merge, stack = {}, [], []
    with open(TOPK) as f:
        for line in f:
            m = re.match(r"#if TOPK_IN_PART\((\d)\)", line)
            if m:
                stack.append(int(m.group(1)))
                continue
            if line.startswith("#if"):
                stack.append(None)
                continue
            if line.startswith("#endif"):
                stack.pop()
                continue
            part = next((p for p in reversed(stack) if p is not None), "every")
            m = re.match(r'extern "C" int (\w+)\(', line)
            if m:
                entries.setdefault(part, []).append(m.group(1))
            if re.match(r"\s+topk_merge_kernel\(", line):
                merge.append(part)
    assert not stack
    return entries, merge


@pytest.mark.parametrize("part, names", [
    (0, ["tat_topk_scan", "tat_topk_merge"]),
    (1, ["tat_topk_scan_iv"]),
    (2, ["tat_topk_scan_mask"]),
    (3, ["tat_topk_scan_q", "tat_topk_scan_mq"]),
])
def test_each_topk_entry_point_is_defined_in_one_part(part, names):
    entries, merge = _topk_parts()
    assert entries[part] == names
    assert "every" not in entries  # no entry point outside a part
    assert merge == [0]  # the one non-template kernel, defined once


def _narrow_entries():
    """The entry points of ``topk_narrow.cu`` (K6 and K7 up to 16 queries),
    a unit of its own."""
    with open(os.path.join(_build.CSRC_DIR, "topk_narrow.cu")) as f:
        return re.findall(r'^extern "C" int (\w+)\(', f.read(), re.M)


def test_the_parts_define_every_topk_entry_point_the_loader_declares():
    entries, _ = _topk_parts()
    narrow = _narrow_entries()
    assert narrow == ["tat_topk_narrow_plan", "tat_topk_scan_q_narrow", "tat_topk_scan_mq_narrow"]
    defined = sorted([n for names in entries.values() for n in names] + narrow)
    declared = sorted(n for n in _declare_names() if n.startswith("tat_topk_"))
    assert defined == declared


def _declare_names():
    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            object.__setattr__(self, name, fn)
            return fn

    lib = Lib()
    _build._declare(lib)
    return list(vars(lib))


@pytest.fixture
def fresh_builder(monkeypatch):
    monkeypatch.setattr(_build, "_kernels", None)
    monkeypatch.setattr(_build, "_builder", None)
    yield
    if _build._builder is not None:
        _build._builder.join(timeout=10)


def test_start_building_returns_at_once_and_builds_once(fresh_builder, monkeypatch):
    release, calls = threading.Event(), []

    def slow_kernels():
        calls.append(threading.current_thread().name)
        assert release.wait(10)

    monkeypatch.setattr(_build, "kernels", slow_kernels)
    _build.start_building()
    _build.start_building()  # already started: no second thread
    assert _build._builder.is_alive()
    release.set()
    _build._builder.join(timeout=10)
    assert calls == ["tat-kernels-build"]
    assert _build._builder.daemon


def test_start_building_leaves_a_failed_build_to_the_first_launch(fresh_builder, monkeypatch):
    def failing_kernels():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "kernels", failing_kernels)
    _build.start_building()
    _build._builder.join(timeout=10)
    assert not _build._builder.is_alive()  # the thread ended without raising


def test_start_building_does_nothing_once_the_library_is_loaded(fresh_builder, monkeypatch):
    monkeypatch.setattr(_build, "_kernels", object())
    _build.start_building()
    assert _build._builder is None


@pytest.mark.parametrize("kind", ["sharded", "corpus", "vector_store"])
def test_a_store_on_the_cpu_starts_no_build(kind, monkeypatch):
    started = []
    monkeypatch.setattr(_build, "start_building", lambda: started.append(1))
    if kind == "sharded":
        from typeagent_tpu_torch.parallel.sharded import ShardedVectorStore

        ShardedVectorStore(8, device="cpu")
    elif kind == "corpus":
        from typeagent_tpu_torch.parallel.corpus import CorpusVectorStore

        CorpusVectorStore(8, device="cpu", dtype="int8")
    else:
        from typeagent_tpu_torch.models.adapters import create_test_embedding_model
        from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

        VectorStore(TextEmbeddingIndexSettings(create_test_embedding_model(8),
                                               device=torch.device("cpu")))
    assert started == []
