"""Single declared registry of every data-path counter the stack emits.

Motivation: counters are the observability contract of the whole fleet —
the benchmark gates, the fault-soak assertions and the smoke gate all key
off `data_path_counters()` dict keys and `note_recovery()` path strings.
A typo'd key (`"ec.cel_retry"`) is silent: it ships a counter nobody
reads and starves the assertion that was supposed to watch it.  This
module closes that hole from both sides:

  * statically — the `counter` pass of ``python -m tools.analysis.lint``
    parses the literal sets below straight out of this file's AST and
    checks every ``note_recovery(...)`` literal, every ``.stats.<field>``
    increment and every literal key built inside a
    ``data_path_counters()`` body against them;

  * at runtime — both ``data_path_counters()`` implementations (per-target
    session and cluster router) funnel their result through :func:`verify`
    before returning it, so an undeclared key can never reach a benchmark
    or a test unnoticed.

The sets are written as LITERALS on purpose: the lint pass reads them
without importing anything, and a reviewer can diff the observability
surface of a PR in one file.  :func:`validate_registry` cross-checks the
dataclass-backed sections against the live Stats dataclasses so the
literals cannot rot (tests/test_static_analysis.py exercises it).
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, Mapping

# ---------------------------------------------------------------------------
# counter sections, exactly as emitted by data_path_counters()

# Sections rendered with dataclasses.asdict(<Stats>) — the key sets must
# stay bit-identical to the dataclass fields (validate_registry checks).
TRANSPORT_KEYS = frozenset({
    "bytes_moved", "copies", "copy_bytes", "segments", "control_msgs",
    "ops", "rendezvous", "eager", "sg_ops", "descriptors",
    "rkey_resolves", "rkey_cache_hits", "sendmsg_batches",
    "placements", "placed_bytes", "registered_read_bytes",
})

ENGINE_KEYS = frozenset({
    "checksum_bytes", "checksum_skipped_bytes", "verify_hits",
    "verify_misses", "vcache_invalidations", "scrub_bytes",
    "scrub_corruptions", "quorum_acks", "background_commits",
    "replica_demotions", "checksum_offloads", "hedges_issued",
    "hedges_won", "cross_target_rereplications", "heal_deferrals",
    "deferred_heal_bytes", "heal_floor_grants", "ec_rebuilt_cells",
    "scrub_parity_checks", "scrub_parity_mismatches",
})

META_CACHE_KEYS = frozenset({
    "lookup_hits", "lookup_misses", "expiries", "invalidations",
    "rkey_renewals",
})

CRYPTO_KEYS = frozenset({
    "keystream_bytes_generated", "keystream_bytes_served",
    "cache_hits", "cache_misses", "xor_bytes",
})

DIRECT_KEYS = frozenset({
    "reads", "bytes", "device_puts", "batches",
})

# Sections built as literal dicts in client.py.
MEDIA_KEYS = frozenset({
    "host_copy_bytes", "donated_bytes", "writeback_bytes",
    "bytes_written", "bytes_read",
})

CLIENT_KEYS = frozenset({"host_copy_bytes"})

STAGING_KEYS = frozenset({
    "donations", "reclaims", "acquires", "bounce_bytes",
})

CONTROL_KEYS = frozenset({
    "rpc_count", "rpc_bytes", "compound_ops", "invalidations_sent",
})

# Shared completion-queue accounting (submit/reap client API): emitted by
# _CompletionQueue.counters() on every session and merged fleet-wide by
# the router (its own client-level CQ included).
CQ_KEYS = frozenset({
    "submitted", "completed", "inflight_peak", "reap_batches",
    "cancelled",
})

CLUSTER_KEYS = frozenset({
    "targets", "targets_up", "map_version", "map_refreshes",
    "map_invalidations", "target_retries", "retried_runs",
    "placement_cache_hits",
})

EC_KEYS = frozenset({
    "k", "p", "degraded_reads", "reconstructions", "rebuilt_cells",
    "delta_writes", "delta_bytes_saved", "delta_fallbacks",
})

FAULTS_KEYS = frozenset({
    "injected", "injected_by_kind", "recovered",
    "total_injected", "total_recovered",
})

# `faults.injected_by_kind` inner keys are the Fault.kind vocabulary.
FAULT_KINDS = frozenset({
    "error", "partial", "crash", "drop", "delay", "expire",
})

# Every hardened-recovery ledger path (`note_recovery(inj, "<path>")`).
# A path appearing in code but not here is a lint failure — exactly the
# silent-typo class this registry exists to kill.
RECOVERY_PATHS = frozenset({
    "cap.renewed",              # premature rkey expiry renewed in place
    "transport.retry",          # bounded SG wire retransmit succeeded
    "control.rpc_retry",        # dropped control RPC retried once
    "dispatch.retry",           # failed target's fragments re-dispatched
    "media.rereplicated",       # post-ack demotion healed on a local spare
    "read.degraded_replica",    # read failed over to a surviving replica
    "cluster.healed",           # spareless demotion healed on a peer target
    "ec.rebuilt",               # dirty EC cells regenerated by resync
    "ec.cell_retry",            # EC cell op retried once after StorageError
    "ec.cell_write_degraded",   # EC write landed with unreachable cells marked
    "ec.degraded_read",         # EC read reconstructed from k survivors
    "ec.delta_fallback",        # partial-stripe write degraded from the
    # delta-parity path to a full re-encode (touched/parity target down)
    "pipeline.read_retry",      # loader retried a transient storage stall
})

# section name -> declared key set (the top-level shape of
# data_path_counters(); `device_direct` is DirectStats surfaced by the
# benchmark's sink section with the same contract).
COUNTERS: Dict[str, FrozenSet[str]] = {
    "transport": TRANSPORT_KEYS,
    "engine": ENGINE_KEYS,
    "media": MEDIA_KEYS,
    "client": CLIENT_KEYS,
    "staging": STAGING_KEYS,
    "control": CONTROL_KEYS,
    "cq": CQ_KEYS,
    "meta_cache": META_CACHE_KEYS,
    "crypto": CRYPTO_KEYS,
    "faults": FAULTS_KEYS,
    "cluster": CLUSTER_KEYS,
    "ec": EC_KEYS,
    "device_direct": DIRECT_KEYS,
}


class UndeclaredCounterError(KeyError):
    """A data_path_counters() emission contained a key this registry does
    not declare — a typo'd or unregistered counter."""


def verify(counters: Mapping[str, Any]) -> Mapping[str, Any]:
    """Check an emitted counter dict against the registry and return it.

    Both `data_path_counters()` implementations call this on their way
    out, so an undeclared section or leaf key raises instead of shipping.
    Dynamic inner keys are validated where a vocabulary exists
    (`faults.recovered` -> RECOVERY_PATHS, `faults.injected_by_kind` ->
    FAULT_KINDS) and skipped where keys are open-ended hook-point names
    (`faults.injected`).
    """
    bad = []
    for section, body in counters.items():
        declared = COUNTERS.get(section)
        if declared is None:
            bad.append(section)
            continue
        if not isinstance(body, Mapping):
            continue
        for key in body:
            if section == "faults":
                if key not in declared:
                    bad.append(f"{section}.{key}")
                continue
            if key not in declared:
                bad.append(f"{section}.{key}")
        if section == "faults":
            for path in body.get("recovered", ()):
                if path not in RECOVERY_PATHS:
                    bad.append(f"faults.recovered[{path}]")
            for kind in body.get("injected_by_kind", ()):
                if kind not in FAULT_KINDS:
                    bad.append(f"faults.injected_by_kind[{kind}]")
    if bad:
        raise UndeclaredCounterError(
            f"undeclared counter key(s) {sorted(bad)} — declare them in "
            f"core/counters_registry.py (or fix the typo)")
    return counters


def validate_registry() -> None:
    """Cross-check the literal sets against the live Stats dataclasses.

    The registry is literal so the linter can read it statically; this
    function is the runtime guard that the literals track the dataclasses
    field-for-field.  Raises AssertionError on drift.
    """
    from dataclasses import fields

    from repro_torch.core.data_plane import TransportStats
    from repro_torch.core.device_direct import DirectStats
    from repro_torch.core.metadata_cache import MetaCacheStats
    from repro_torch.core.object_store import EngineStats
    from repro_torch.core.smartnic import CryptoStats

    pairs = [
        (TRANSPORT_KEYS, TransportStats, "transport"),
        (ENGINE_KEYS, EngineStats, "engine"),
        (META_CACHE_KEYS, MetaCacheStats, "meta_cache"),
        (CRYPTO_KEYS, CryptoStats, "crypto"),
        (DIRECT_KEYS, DirectStats, "device_direct"),
    ]
    for declared, cls, name in pairs:
        live = {f.name for f in fields(cls)}
        assert declared == live, (
            f"counters_registry.{name} drifted from {cls.__name__}: "
            f"missing={sorted(live - declared)} "
            f"stale={sorted(declared - live)}")
