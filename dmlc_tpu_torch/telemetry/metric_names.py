"""Checked-in registry of every ``dmlc_*`` metric family the system
emits — the metric-name contract (the port of
``dmlc_tpu/telemetry/metric_names.py``: the same three sets, so a
dashboard reads either package).

The exported metric surface only ever *grows*: no renames, additive
only.  A family the port emits must be a name of :data:`METRIC_NAMES`
(the port's tests hold every family its registry, tracker and server
expose against this set), so renaming or typo-duplicating one needs a
*visible* edit here.  A name that only the port emits would go under
its own commented block below.

Removing a name from this set is the signal that a dashboard somewhere
breaks; treat deletions as API breaks.
"""

from __future__ import annotations

__all__ = ["METRIC_NAMES", "SPAN_ANNOTATIONS", "NON_METRIC_TOKENS"]

#: every exported metric family (base name: the exposition-format
#: ``_bucket``/``_sum``/``_count`` suffixes of histograms are implied)
METRIC_NAMES = frozenset({
    # anomaly watchdog (tracker side; slo_* kinds are replica-shipped
    # SLO violations mirrored by Watchdog.ingest_slo)
    "dmlc_anomaly_active",
    "dmlc_anomaly_straggler_flags",
    "dmlc_anomaly_regression_flags",
    "dmlc_anomaly_feed_stall_flags",
    "dmlc_anomaly_goodput_collapse_flags",
    "dmlc_anomaly_slo_ttft_flags",
    "dmlc_anomaly_slo_tbt_flags",
    "dmlc_anomaly_slo_error_rate_flags",
    "dmlc_anomaly_recompile_storm_flags",
    # compute observability (telemetry.compute): compile ledger
    # (hand-rendered per-site *_total families + registry families),
    # HBM accounting, per-phase time shares
    "dmlc_compute_recompiles_total",
    "dmlc_compute_traces_total",
    "dmlc_compute_cache_hits_total",
    "dmlc_compute_compile_secs",
    "dmlc_compute_aot_fallbacks",
    "dmlc_compute_hbm_live_bytes",
    "dmlc_compute_hbm_peak_bytes",
    "dmlc_compute_hbm_headroom_bytes",
    "dmlc_compute_phase_gather_share",
    "dmlc_compute_phase_attention_share",
    "dmlc_compute_phase_mlp_share",
    "dmlc_compute_phase_unembed_share",
    "dmlc_compute_phase_sampling_share",
    # elastic world resize (tracker generations + client + launcher)
    "dmlc_elastic_resizes_total",
    "dmlc_elastic_shrinks_total",
    "dmlc_elastic_grows_total",
    "dmlc_elastic_generation",
    "dmlc_elastic_world_size",
    "dmlc_elastic_client_resizes",
    "dmlc_elastic_gang_reschedules",
    # checkpoint
    "dmlc_checkpoint_bytes_read",
    "dmlc_checkpoint_bytes_written",
    "dmlc_checkpoint_restore_secs",
    "dmlc_checkpoint_restores",
    "dmlc_checkpoint_save_secs",
    "dmlc_checkpoint_saves",
    # host + device collectives
    "dmlc_collective_barrier_sum_calls",
    "dmlc_collective_barrier_wait_secs",
    "dmlc_collective_bench_build_secs",
    "dmlc_collective_bench_host_run_secs",
    "dmlc_collective_bench_loopback_probe_secs",
    "dmlc_collective_bench_run_secs",
    "dmlc_collective_overlap_buckets",
    "dmlc_collective_overlap_bucket_secs",
    # device feed
    "dmlc_feed_assemble_secs",
    "dmlc_feed_autotune_adjustments",
    "dmlc_feed_autotune_depth",
    "dmlc_feed_autotune_workers",
    "dmlc_feed_batches",
    "dmlc_feed_bytes_to_device",
    "dmlc_feed_consumer_stall_secs",
    "dmlc_feed_crc_secs",
    "dmlc_feed_depth",
    "dmlc_feed_device_put_secs",
    "dmlc_feed_pack_secs",
    "dmlc_feed_parse_native_secs",
    "dmlc_feed_producer_stall_secs",
    "dmlc_feed_queue_depth",
    "dmlc_feed_resizes",
    "dmlc_feed_stage_stall_secs",
    "dmlc_feed_staging_pool_bytes",
    # flash attention
    "dmlc_flash_fwd_calls",
    "dmlc_flash_fwd_flops",
    "dmlc_flash_ring_step_calls",
    "dmlc_flash_seq_len_q",
    # input split / io
    "dmlc_input_split_bytes",
    "dmlc_input_split_chunk_latency_secs",
    "dmlc_input_split_chunks",
    "dmlc_input_split_producer_idle_secs",
    "dmlc_input_split_records",
    "dmlc_io_read_bytes",
    "dmlc_io_reads",
    "dmlc_io_write_bytes",
    "dmlc_io_writes",
    # data integrity (io.integrity: CRC32C framing, quarantine,
    # verified reads, checkpoint digests, epoch-cache footer)
    "dmlc_integrity_corrupt_records",
    "dmlc_integrity_quarantined_spans",
    "dmlc_integrity_skiplist_drops",
    "dmlc_integrity_read_verify_failures",
    "dmlc_integrity_checksum_failures",
    "dmlc_io_cache_integrity_failures",
    # model / moe
    "dmlc_moe_overflow_checks",
    "dmlc_moe_overflow_fraction_sum",
    # data parsers
    "dmlc_parser_blocks",
    "dmlc_parser_bytes",
    "dmlc_parser_parse_secs",
    "dmlc_parser_rows",
    # pipeline parallelism
    "dmlc_pipeline_bubble_fraction",
    "dmlc_pipeline_bubble_steps_per_stage",
    "dmlc_pipeline_microbatches",
    "dmlc_pipeline_microbatches_per_run",
    "dmlc_pipeline_runs_traced",
    "dmlc_pipeline_stages",
    # recordio
    "dmlc_recordio_bytes",
    "dmlc_recordio_partition_scan_secs",
    "dmlc_recordio_records",
    # self-healing training loop (resilience.selfheal)
    "dmlc_selfheal_skips",
    "dmlc_selfheal_rollbacks",
    "dmlc_selfheal_aborts",
    "dmlc_selfheal_nonfinite_steps",
    "dmlc_selfheal_spike_steps",
    # resilience
    "dmlc_resilience_faults_injected",
    "dmlc_resilience_hosts_blacklisted",
    "dmlc_resilience_postmortems_collected",
    "dmlc_resilience_retries",
    "dmlc_resilience_retryable_errors",
    "dmlc_resilience_task_budget_exhausted",
    "dmlc_resilience_task_restarts",
    "dmlc_resilience_worker_declared_dead",
    "dmlc_resilience_worker_readmitted",
    # ring attention
    "dmlc_ring_attention_bytes_rotated",
    "dmlc_ring_attention_calls",
    "dmlc_ring_attention_kv_block_bytes",
    # serving plane (dmlc_tpu/serving)
    "dmlc_serving_active_requests",
    "dmlc_serving_completed",
    "dmlc_serving_decode_batch",
    "dmlc_serving_decode_steps",
    "dmlc_serving_draining",
    "dmlc_serving_failed",
    "dmlc_serving_kv_alloc_failures",
    "dmlc_serving_kv_blocks_in_use",
    "dmlc_serving_kv_blocks_total",
    "dmlc_serving_kv_occupancy_pct",
    "dmlc_serving_kv_waste_tokens",
    "dmlc_serving_latency_secs",
    "dmlc_serving_nonfinite_failures",
    "dmlc_serving_preemptions",
    "dmlc_serving_prefill_secs",
    "dmlc_serving_prefill_tokens",
    "dmlc_serving_queue_depth",
    "dmlc_serving_queue_wait_secs",
    "dmlc_serving_rejected",
    "dmlc_serving_requests",
    "dmlc_serving_resumes",
    "dmlc_serving_tbt_secs",
    "dmlc_serving_tokens_generated",
    "dmlc_serving_tokens_per_s_per_user",
    "dmlc_serving_ttft_secs",
    # serving HTTP edge: per-status-code /generate response counters
    # (serving/server.py _STATUS_COUNTERS)
    "dmlc_serving_http_200",
    "dmlc_serving_http_400",
    "dmlc_serving_http_404",
    "dmlc_serving_http_413",
    "dmlc_serving_http_429",
    "dmlc_serving_http_503",
    "dmlc_serving_http_other",
    # serving per-reason failure counters (telemetry.requests
    # FAIL_REASONS; "dmlc_serving_failed_" + slug)
    "dmlc_serving_failed_shutdown",
    "dmlc_serving_failed_crash",
    "dmlc_serving_failed_prefill",
    "dmlc_serving_failed_nonfinite",
    "dmlc_serving_failed_kv_exhausted",
    "dmlc_serving_failed_other",
    # serving idempotency + crash-requeue (engine dedupe ring,
    # requeue-on-crash)
    "dmlc_serving_dedupe_hits",
    "dmlc_serving_crash_requeues",
    # serving compile-signature hygiene (engine prompt padding buckets
    # and the decode jit-signature population)
    "dmlc_serving_prompt_bucket_new",
    "dmlc_serving_decode_signatures",
    # decode fast path — paged attention (pool read in place, no dense
    # gather) and speculative decoding (n-gram drafts, exact verify)
    "dmlc_serving_paged_active",
    "dmlc_serving_paged_decode_steps",
    "dmlc_serving_spec_proposed",
    "dmlc_serving_spec_accepted",
    "dmlc_serving_spec_accept_rate",
    "dmlc_serving_spec_tokens_per_step",
    # fleet router (serving/router.py): dispatch/retry/hedge/failover
    # counters, fleet health gauges, routed latency/TTFT, per-status
    # edge counters, and the hand-rendered per-replica labeled families
    "dmlc_router_requests",
    "dmlc_router_completed",
    "dmlc_router_failed",
    "dmlc_router_dispatches",
    "dmlc_router_retries",
    "dmlc_router_failovers_total",
    "dmlc_router_hedges",
    "dmlc_router_hedge_wins",
    # hedge losers reaped after the winner returned: count + their
    # wasted generated tokens (satellite of the fleet-tracing PR)
    "dmlc_router_hedge_abandoned",
    "dmlc_router_hedge_abandoned_tokens",
    "dmlc_router_drain_shifts",
    "dmlc_router_replica_down_total",
    "dmlc_router_probe_recoveries",
    "dmlc_router_rejected_busy",
    "dmlc_router_replicas_healthy",
    "dmlc_router_replicas_down",
    "dmlc_router_replicas_draining",
    "dmlc_router_latency_secs",
    "dmlc_router_ttft_secs",
    "dmlc_router_http_200",
    "dmlc_router_http_400",
    "dmlc_router_http_404",
    "dmlc_router_http_429",
    "dmlc_router_http_503",
    "dmlc_router_http_other",
    "dmlc_router_replica_health",
    "dmlc_router_replica_inflight",
    "dmlc_router_replica_queue_depth",
    "dmlc_router_replica_dispatches",
    "dmlc_router_replica_failures",
    # dynamic replica registry (autoscaler surface on the router)
    "dmlc_router_replicas_added",
    "dmlc_router_replicas_removed",
    # per-tenant fairness (TenantGovernor): router-registry counter +
    # hand-rendered tenant-labeled families
    "dmlc_router_tenant_rejections",
    "dmlc_tenant_requests_total",
    "dmlc_tenant_admitted_total",
    "dmlc_tenant_rejected_total",
    "dmlc_tenant_tokens_generated_total",
    "dmlc_tenant_bucket_level",
    "dmlc_tenant_weight",
    # fleet autoscaler (fleet/autoscaler.py): hand-rendered label-free
    # control-loop families on the router /metrics
    "dmlc_fleet_replicas",
    "dmlc_fleet_owned_replicas",
    "dmlc_fleet_utilization",
    "dmlc_fleet_slo_hot",
    "dmlc_fleet_high_streak",
    "dmlc_fleet_low_streak",
    "dmlc_fleet_cooldown_remaining_s",
    "dmlc_fleet_saturated",
    "dmlc_fleet_ticks_total",
    "dmlc_fleet_scale_ups_total",
    "dmlc_fleet_scale_downs_total",
    "dmlc_fleet_saturations_total",
    # fleet_saturated anomaly flag events (Watchdog._flag counter)
    "dmlc_anomaly_fleet_saturated_flags",
    # serving SLO monitor (telemetry.slo): counter + hand-rendered
    # labeled gauge families on the serving /metrics
    "dmlc_slo_violations",
    "dmlc_slo_burn_rate",
    "dmlc_slo_violation_active",
    "dmlc_slo_objective_threshold",
    # job-level goodput/badput ledger (telemetry.goodput): per-rank
    # hand-rendered labeled families + cluster rollups on the tracker
    "dmlc_goodput_bucket_seconds",
    "dmlc_goodput_fraction",
    "dmlc_goodput_effective_tokens_per_s",
    "dmlc_goodput_cluster_fraction",
    "dmlc_goodput_cluster_bucket_seconds",
    "dmlc_goodput_cluster_effective_tokens_per_s",
    # serving-replica availability ledger (telemetry.goodput
    # AvailabilityLedger; hand-rendered on the serving /metrics)
    "dmlc_availability_state_seconds",
    "dmlc_availability_fraction",
    "dmlc_availability_tokens_served_total",
    "dmlc_availability_capacity_tokens",
    # effective-goodput-collapse anomaly flag events (Watchdog._flag
    # counter, fed by the goodput heartbeat sub-doc)
    "dmlc_anomaly_effective_goodput_collapse_flags",
    # step ledger
    "dmlc_step_checkpoint_stall_secs",
    "dmlc_step_collective_secs",
    "dmlc_step_collective_overlapped_secs",
    "dmlc_step_compute_secs",
    "dmlc_step_count",
    "dmlc_step_feed_wait_secs",
    "dmlc_step_goodput_tokens_per_s",
    "dmlc_step_membw_util_pct",
    "dmlc_step_memory_bound",
    "dmlc_step_mfu_pct",
    "dmlc_step_time_secs",
    # decode fast path: committed tokens per batch row and the
    # speculative-decoding draft acceptance (telemetry.steps)
    "dmlc_step_tokens_per_step",
    "dmlc_step_spec_accept_rate_pct",
    # telemetry self-accounting
    "dmlc_telemetry_beats_truncated",
    # tracker surface (hand-rendered families)
    "dmlc_build_info",
    "dmlc_heartbeat_age_seconds",
    "dmlc_tracker_ranks_reporting",
    "dmlc_tracker_rejected_announces",
    # training loop examples
    "dmlc_train_steps",
    # smoke-harness fixtures (scripts/telemetry_smoke.py workers)
    "dmlc_smoke_beats",
    # port-only: bytes a gloo point-to-point of a CUDA tensor stages
    # through pinned host memory (parallel/collectives.py)
    "dmlc_collective_ppermute_staged_bytes",
})

#: span / jax-profiler annotation names that look like metric tokens in
#: string scans but are trace names, not exposition families
SPAN_ANNOTATIONS = frozenset({
    "dmlc_train_step",
    "dmlc_feed_batch",
})

#: non-metric ``dmlc_*`` identifiers that legitimately appear in string
#: literals (package / native-library / ABI-symbol / path names, and
#: prose prefixes like "dmlc_anomaly_*")
NON_METRIC_TOKENS = frozenset({
    "dmlc_tpu",
    "dmlc_tpu_bench",
    "dmlc_native",
    "dmlc_collective",
    "dmlc_kv",
    "dmlc_sge",
    "dmlc_top",
    "dmlc_tracker",       # reference repo path tracker/dmlc_tracker/…
    "dmlc_anomaly",       # prose prefix for the dmlc_anomaly_* family
    "dmlc_goodput",       # prose prefix for the dmlc_goodput_* family
    "dmlc_availability",  # prose prefix for the dmlc_availability_* family
    "dmlc_compute",       # prose prefix for the dmlc_compute_* family
    "dmlc_elastic",       # prose prefix for the dmlc_elastic_* family
    "dmlc_integrity",     # prose prefix for the dmlc_integrity_* family
    "dmlc_selfheal",      # prose prefix for the dmlc_selfheal_* family
    "dmlc_serving",       # prose prefix for the dmlc_serving_* family
    "dmlc_serve",         # bin/dmlc-serve launcher name in prose
    "dmlc_router",        # prose prefix for the dmlc_router_* family
    "dmlc_router_replica",  # prose prefix: dmlc_router_replica_<field>
    "dmlc_tenant",        # prose prefix for the dmlc_tenant_* family
    "dmlc_fleet",         # prose prefix for the dmlc_fleet_* family
    "dmlc_slo",           # prose prefix for the dmlc_slo_* family
    "dmlc_serving_http",  # prose prefix: dmlc_serving_http_<code>
    "dmlc_recordio_spans",  # native ABI symbol (dmlc_native.cc)
    "dmlc_recordio_spans_verify",  # native ABI symbol (fused scan+verify)
    "dmlc_pack_spans",      # native ABI symbol
    "dmlc_pad_pack_rows",   # native ABI symbol (spans -> padded rows)
    "dmlc_pad_pack_csr",    # native ABI symbol (CSR -> padded batch)
    "dmlc_parse_libsvm_into",  # native ABI symbol (fused tokenize+pack)
    "dmlc_comm_allreduce",  # native collective ABI symbol
    "dmlc_shm_coll",        # native shm-group ABI symbol prefix
    "dmlc_check",           # scripts/dmlc_check.py static-analysis suite
    "dmlc_crc32c",          # native ABI symbol (dmlc_native.cc)
})

#: the port's own non-metric ``dmlc_*`` identifiers: its package name and
#: the symbols its C and CUDA libraries export (``ops/csrc/``,
#: ``native/csrc/``), which the wrappers name in ``ctypes`` lookups.
#: Kept apart from :data:`NON_METRIC_TOKENS`, which stays the JAX
#: package's set, so the two registries compare set for set.
PORT_NON_METRIC_TOKENS = frozenset({
    "dmlc_tpu_torch",
    # the CUDA kernels (ops/csrc/*.cu)
    "dmlc_flash_fwd",
    "dmlc_flash_bwd_dkv",
    "dmlc_flash_bwd_dq",
    "dmlc_paged_attention",
    # the native core (native/csrc/crc32c.cc, dmlc_native.cc)
    "dmlc_crc32c_table",
    "dmlc_crc32c_hw",
    "dmlc_native_abi_version",
    "dmlc_parse_libsvm",
    "dmlc_parse_libfm",
    "dmlc_parse_csv",
    "dmlc_recordio_find_last",
    "dmlc_gather_spans",
})
