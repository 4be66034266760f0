"""The kernels' build and launch counts under threads (CPU, nvcc stubbed).

The calc-delays workflow launches B1 from its prefetch thread while the
main thread launches B2, so the library's first build and load and the
launch counts must hold under two threads: the build runs once, its
object files are named per process and thread, and no count is lost.
"""

import ctypes
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import raider_tpu_torch.kernels as kernels


def test_two_threads_build_and_load_once(monkeypatch, tmp_path):
    built = []

    def build():
        built.append(threading.get_ident())
        time.sleep(0.05)               # both threads are inside lib() by now
        return tmp_path / 'lib.so'

    monkeypatch.setattr(kernels, '_lib', None)
    monkeypatch.setattr(kernels, 'build', build)
    monkeypatch.setattr(ctypes, 'CDLL', lambda path: mock.MagicMock(name=path))
    start = threading.Barrier(2)
    got = []

    def first_use():
        start.wait()
        got.append(kernels.lib())

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(built) == 1 and len(got) == 2 and got[0] is got[1]


def test_object_files_are_named_per_thread(monkeypatch, tmp_path):
    """Two builds at once (two threads of one process) write distinct
    object files and temporary libraries."""
    outputs = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            outputs.append(cmd[cmd.index('-o') + 1])
            Path(outputs[-1]).write_bytes(b'')

        def communicate(self):
            time.sleep(0.02)
            return '', ''

    def run(cmd, **kwargs):
        outputs.append(cmd[cmd.index('-o') + 1])
        Path(outputs[-1]).write_bytes(b'')
        return subprocess.CompletedProcess(cmd, 0, '', '')

    monkeypatch.setattr(kernels, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(kernels, 'library_path', lambda: tmp_path / 'lib.so')
    monkeypatch.setattr(kernels, '_nvcc', lambda: 'nvcc')
    monkeypatch.setattr(subprocess, 'Popen', Proc)
    monkeypatch.setattr(subprocess, 'run', run)
    start = threading.Barrier(2)

    def build():
        start.wait()
        kernels.build()

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    n_sources = len(list(kernels.CSRC.glob('*.cu')))
    assert len(outputs) == 2 * (n_sources + 1) and len(set(outputs)) == len(outputs)
    assert (tmp_path / 'lib.so').exists()


def test_launch_counts_from_threads_add_up(monkeypatch):
    """More threads than cores, switching often: no count is lost."""
    monkeypatch.setattr(kernels, 'LAUNCHES', dict(kernels.LAUNCHES))
    kernels.reset_launch_counts()

    def count(name):
        for _ in range(2000):
            kernels._count(name)

    threads = [threading.Thread(target=count, args=(n,))
               for n in ('ztd_totals', 'brick_integrate') * 12]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert kernels.LAUNCHES['ztd_totals'] == kernels.LAUNCHES['brick_integrate'] == 24000
