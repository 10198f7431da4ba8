"""The port's copy of the telemetry substrate -- metrics registry, event
journal, span tracing -- and of the logger's process index, held to the
JAX package's own telemetry and tracing tests: each case runs once per
package, the port's with its imports re-pointed at the port."""

import logging

import pytest

from dlrover_tpu.common import log as jax_log
from dlrover_tpu_torch.common import log
from dlrover_tpu_torch.telemetry import journal, tracing

from tests.test_torch_control_plane import (
    PACKAGES,
    run_repointed,
    stop_background_loops,
)

REPOINTED = {
    "test_telemetry.py": [
        "test_counter_gauge_lifecycle",
        "test_labels_are_distinct_series",
        "test_get_or_create_and_kind_conflict",
        "test_histogram_buckets_cumulative_and_sum",
        "test_prometheus_text_format_validity",
        "test_registry_json_dump",
        "test_journal_seq_monotonic_and_file_roundtrip",
        "test_journal_kind_prefix_filter_and_payload_isolation",
        "test_journal_ring_bounded",
        "test_read_journal_skips_torn_lines",
        "test_journal_rotation_caps_disk_contiguous_tail",
        "test_journal_resync_follows_sibling_rotation",
        "test_read_journal_survives_rotation_mid_stitch",
        "test_journal_envelope_stamps_job_id",
        "test_default_journal_env_configured",
    ],
    "test_tracing.py": [
        "test_disabled_span_is_shared_noop_and_allocation_free",
        "test_span_records_carry_journal_envelope",
        "test_span_marks_errors_and_propagates",
        "test_ring_wraparound_keeps_newest",
        "test_add_span_retroactive_and_disabled_noop",
        "test_summarize_aggregates_by_name",
        "test_write_through_and_chrome_merge",
        "test_cross_process_merge_two_pids_deterministic",
        "test_torn_span_lines_skipped",
    ],
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", [
    (f, t) for f, names in REPOINTED.items() for t in names
], ids=lambda c: f"{c[0][:-3]}::{c[1]}")
def test_jax_case_in_both_packages(case, pkg, request):
    test_file, test_name = case
    if test_name == "test_disabled_span_is_shared_noop_and_allocation_free":
        # it counts the interpreter's allocated blocks, which loops that
        # earlier tests left running add to
        stop_background_loops()
    run_repointed(test_file, pkg, test_name, request)


@pytest.mark.parametrize("mod", [jax_log, log], ids=PACKAGES)
def test_process_index_from_env_then_set(mod, monkeypatch):
    monkeypatch.setattr(mod, "_process_index", None)
    monkeypatch.setenv("DLROVER_TPU_PROCESS_ID", "3")
    assert mod.current_process_index() == 3
    mod.set_process_index(5)
    assert mod.current_process_index() == 5
    record = logging.LogRecord("x", logging.INFO, "f.py", 1, "m", (), None)
    mod._ProcTagFilter().filter(record)
    assert record.proc_tag == " [proc 5]"


def test_journal_and_spans_carry_the_port_process_index(monkeypatch):
    monkeypatch.setattr(log, "_process_index", 7)
    jr = journal.EventJournal(None)
    assert jr.record("x.y")["proc"] == 7
    tracing.enable(capacity=8)
    try:
        with tracing.span("s"):
            pass
        assert tracing.tail(1)[0]["proc"] == 7
    finally:
        tracing.disable()
        tracing.clear()
