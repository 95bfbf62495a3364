"""Suite-wide plugins: the lock-order witness and the leak witness.

Two runtime analyses ride every test run (tools/analysis):

  * ``--lockgraph``: wrap every lock allocated from repo code and record
    the global acquisition-order graph; a cycle (two paths taking the
    same pair of locks in opposite orders) fails the test that completed
    it even if the deadlock interleaving never fired. ``make check``
    runs the suite with this on; plain ``make test`` (tier-1) does not.

  * ``leak_witness`` (always on, storage modules): every ROS2Client and
    DeviceDirectSink constructed during a test is tracked; at teardown
    whatever the test left open is closed and the structural end-state
    invariants asserted — donated slots drained, staging free lists
    whole, no rkey grant outliving its op, every repo service thread
    exited. Each storage test doubles as a leak test.
"""
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:          # `tools` lives at the root
    sys.path.insert(0, str(REPO_ROOT))

from tools.analysis import leakwitness, lockgraph  # noqa: E402

# Modules that exercise the storage stack end to end (construct clients
# or sinks); the leak witness applies to each of them.
STORAGE_MODULES = {
    "test_checkpoint", "test_cluster", "test_control_plane",
    "test_core_storage", "test_device_direct", "test_direct_read_path",
    "test_erasure", "test_fault_storage", "test_pipeline",
    "test_properties", "test_serve", "test_sg_data_path",
    "test_zero_copy_path",
}


def pytest_addoption(parser):
    parser.addoption(
        "--lockgraph", action="store_true", default=False,
        help="witness repo lock acquisition order; fail tests that "
             "complete a lock-order cycle (latent deadlock)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none "
        "(on the card: python -m pytest -m cuda tests/test_torch_*.py)")
    if config.getoption("--lockgraph"):
        # install before collection so module-level locks are witnessed
        graph = lockgraph.install([str(REPO_ROOT / "src")],
                                  label_root=str(REPO_ROOT))
        config._lockgraph = graph
        config._lockgraph_reported = set()


def pytest_unconfigure(config):
    if getattr(config, "_lockgraph", None) is not None:
        lockgraph.uninstall()
        config._lockgraph = None


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    graph = getattr(config, "_lockgraph", None)
    if graph is None:
        return
    terminalreporter.write_sep(
        "-", f"lockgraph: {graph.n_acquires} acquisitions, "
             f"{sum(len(v) for v in graph.edges.values())} ordered "
             f"site pairs, {len(graph.cycles())} cycle(s), "
             f"{len(graph.self_edges)} same-site nesting(s)")


@pytest.fixture(autouse=True)
def _lockgraph_guard(request):
    """Fail the test on whose watch a lock-order cycle first appears
    (edges accumulate across tests — allocation sites are code
    locations, so cross-test ordering evidence is still evidence)."""
    yield
    graph = getattr(request.config, "_lockgraph", None)
    if graph is None:
        return
    reported = request.config._lockgraph_reported
    fresh = [c for c in graph.cycles() if tuple(c) not in reported]
    if fresh:
        reported.update(tuple(c) for c in fresh)
        pytest.fail(
            "lock-order cycle (latent deadlock) witnessed:\n"
            + graph.report(), pytrace=False)


@pytest.fixture(autouse=True)
def leak_witness(request, monkeypatch):
    """Track clients/sinks built during storage tests; close and assert
    the leak invariants at teardown (see tools/analysis/leakwitness)."""
    if request.module.__name__.rpartition(".")[2] not in STORAGE_MODULES:
        yield None
        return
    from repro.core.client import ROS2Client
    from repro.core.device_direct import DeviceDirectSink

    witness = leakwitness.LeakWitness()
    client_init = ROS2Client.__init__
    sink_init = DeviceDirectSink.__init__

    def tracked_client_init(self, *a, **k):
        client_init(self, *a, **k)
        witness.track_client(self)

    def tracked_sink_init(self, *a, **k):
        sink_init(self, *a, **k)
        witness.track_sink(self)

    monkeypatch.setattr(ROS2Client, "__init__", tracked_client_init)
    monkeypatch.setattr(DeviceDirectSink, "__init__", tracked_sink_init)
    yield witness
    monkeypatch.undo()
    problems = witness.finish()
    if problems:
        pytest.fail("leak witness: " + "; ".join(problems), pytrace=False)
