"""Test settings of the benchmark's own tests (``python -m pytest perfbench``):
the ``card`` marker, for tests that need an NVIDIA card and skip without
one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")
