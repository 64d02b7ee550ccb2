"""Fixtures shared by the port's test files; no tests of its own.

A file imports a fixture here by name (pytest registers the fixtures a
test module holds, imported ones too)."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def _empty_jax_step_event_ring():
    """paddle_tpu's step-event ring (FLAGS_metrics_ring, 1024 entries) is
    shared by every test file on this worker: leave it empty for the next
    file (tests/test_cost_ledger.py counts the records a dispatch adds,
    and a full ring hides them).  Every port test file that drives
    paddle_tpu's executor imports it."""
    yield
    from paddle_tpu.fluid import telemetry
    telemetry.reset_step_events()
