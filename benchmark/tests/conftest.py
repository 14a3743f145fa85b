"""Every CPU test of the benchmark runs its checks at the test sizes."""

import pytest

from benchmark.tests.tiny import use_test_sizes


@pytest.fixture(autouse=True)
def _test_sizes(monkeypatch):
    use_test_sizes(monkeypatch.setattr)
