"""utils/build.py, the keyed, atomic and locked first-use build that the
compositors (nvcc) and the image codec (the host C++ compiler) share: a
library is named by a hash of its inputs, built once however many threads
ask for it at once, renamed into place whole, and a failed build raises
naming its command and leaves nothing behind."""
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from langsplat4d_torch.utils import build

WRITE = ("import sys, time; time.sleep(0.2); "
         "open(sys.argv[1], 'w').write(sys.argv[2]); print('built', "
         "sys.argv[2])")


def _writer(text):
    return lambda out: [sys.executable, "-c", WRITE, out, text]


def test_keyed_path_hashes_every_input(tmp_path):
    a = build.keyed_path(tmp_path, "k", b"source", b"flags")
    assert a.parent == tmp_path and a.name.startswith("k_")
    assert a.suffix == ".so"
    assert a == build.keyed_path(tmp_path, "k", b"source", b"flags")
    assert a != build.keyed_path(tmp_path, "k", b"source", b"flags2")
    assert a != build.keyed_path(tmp_path, "k", b"source2", b"flags")


def test_builds_each_library_with_its_log(tmp_path):
    libs = {tmp_path / f"{n}.so": _writer(n) for n in ("a", "b")}
    build.build(libs, log=True)
    for lib in libs:
        assert lib.read_text() == lib.stem
        assert lib.with_suffix(".log").read_text() == f"built {lib.stem}\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "a.log", "a.so", "b.log", "b.so"]
    # a library that exists is not built again
    build.build({lib: _writer("again") for lib in libs})
    assert all(lib.read_text() == lib.stem for lib in libs)


def test_concurrent_first_uses_build_once(tmp_path, monkeypatch):
    lib = tmp_path / "x.so"
    runs, popen = [], build.subprocess.Popen

    def counted(cmd, **kw):
        runs.append(cmd)
        return popen(cmd, **kw)
    monkeypatch.setattr(build.subprocess, "Popen", counted)
    start = threading.Barrier(6)

    def first_use(i):
        start.wait()
        build.build({lib: _writer(f"thread {i}")})
        return lib.read_text()
    with ThreadPoolExecutor(6) as ex:
        got = set(ex.map(first_use, range(6)))
    assert len(runs) == 1 and len(got) == 1
    assert [p.name for p in tmp_path.iterdir()] == ["x.so"]


def test_failure_names_the_command_and_leaves_nothing(tmp_path):
    lib = tmp_path / "bad.so"
    fail = lambda out: [sys.executable, "-c",
                        "import sys; print('no such header'); sys.exit(3)",
                        out]
    with pytest.raises(RuntimeError, match=r"failed \(3\) to build bad\.so"
                       r"(.|\n)*no such header"):
        build.build({lib: fail})
    assert list(tmp_path.iterdir()) == []
