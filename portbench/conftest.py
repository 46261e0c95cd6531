"""pytest settings of the benchmark's own tests (run: pytest portbench/)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped without one")
