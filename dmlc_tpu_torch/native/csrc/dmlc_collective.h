/*
 * dmlc_collective.h — native-consumer collective C ABI (SURVEY.md §7 step 9).
 *
 * The substrate role of the reference (README.md:9 "backbone library to
 * support all DMLC projects") is that NATIVE binaries — XGBoost-style,
 * rabit-linked — can rendezvous and allreduce under the launcher's env
 * contract.  This header is that surface for the TPU rebuild: a C program
 * links libdmlc_collective.so, calls dmlc_comm_init() under `dmlc-submit`,
 * and gets rank/world + tree allreduce/broadcast/allgather over the
 * tracker's brokered TCP overlay (protocol: tracker/dmlc_tracker/
 * tracker.py:24-135 behavior; topology tracker.py:165-252) — zero
 * NCCL/CUDA/MPI dependency.  The TPU *device* data plane stays in XLA
 * collectives (dmlc_tpu/parallel/collectives.py); this ABI is the host
 * control/data plane that rabit provided downstream.
 *
 * Env contract (read by dmlc_comm_init):
 *   DMLC_TRACKER_URI   tracker host (default 127.0.0.1)
 *   DMLC_TRACKER_PORT  tracker port (default 9091)
 *   DMLC_TASK_ID       job id used for rank re-admission (default "NULL")
 */
#ifndef DMLC_COLLECTIVE_H_
#define DMLC_COLLECTIVE_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef struct DmlcComm DmlcComm;

/* dtype codes for allreduce */
enum {
  DMLC_F32 = 0,
  DMLC_F64 = 1,
  DMLC_I32 = 2,
  DMLC_I64 = 3,
};

/* reduction ops */
enum {
  DMLC_SUM = 0,
  DMLC_MAX = 1,
  DMLC_MIN = 2,
};

/* Rendezvous with the tracker and establish peer links.
 * Returns NULL on failure (no tracker, protocol error). */
DmlcComm* dmlc_comm_init(void);

/* Rank / world size assigned by the tracker. */
int dmlc_comm_rank(const DmlcComm* c);
int dmlc_comm_world_size(const DmlcComm* c);

/* In-place binomial-tree allreduce over `count` elements of `dtype`.
 * Returns 0 on success, -2 on bad dtype/op, -3 if the payload exceeds
 * the 2 GiB frame limit (int32 length frames, shared with the Python
 * peer protocol), -1 on link errors.  All payload-size/argument errors
 * are raised BEFORE any bytes move, so a failed call never desyncs the
 * overlay.  The same limits apply to broadcast (nbytes) and allgather
 * (nbytes * world). */
int dmlc_comm_allreduce(DmlcComm* c, void* data, long count,
                        int dtype, int op);

/* Broadcast `nbytes` from `root`'s buffer to every rank (in place). */
int dmlc_comm_broadcast(DmlcComm* c, void* data, long nbytes, int root);

/* Gather each rank's `nbytes` block into out[world*nbytes], rank order. */
int dmlc_comm_allgather(DmlcComm* c, const void* in, long nbytes, void* out);

/* Relay a message through the tracker's print channel. */
int dmlc_comm_log(DmlcComm* c, const char* msg);

/* Send 'shutdown' to the tracker and release all sockets. */
void dmlc_comm_shutdown(DmlcComm* c);

/* Human-readable description of the last error on this comm ("" if none).
 * Pass NULL to retrieve the (thread-local) reason a dmlc_comm_init call
 * returned NULL. */
const char* dmlc_comm_last_error(const DmlcComm* c);

/* ------------------------------------------------------------------ *
 * Standalone same-host shared-memory collective group (the intra-host
 * leg of the hierarchical allreduce: tracker/client.py groups ranks by
 * host from the tracker's job map, reduce-scatters inside each host
 * through this group, runs the chunked TCP ring across host LEADERS
 * only, then broadcasts back — so one rank per host drives the
 * network).  Unlike DmlcComm this object does no tracker rendezvous:
 * the caller already owns rank assignment and passes an agreed segment
 * name plus a dense [0, world) intra-group rank.
 *
 * Creation is collective: rank 0 creates + sizes the segment (its
 * chunk_kb — <= 0 means DMLC_COLL_SHM_CHUNK_KB, capped to the free
 * /dev/shm space — is authoritative and published in the header);
 * other ranks attach by name.  Everyone blocks until the whole group
 * has mapped, then rank 0 unlinks the name so a crashed job leaves no
 * /dev/shm litter.  NULL on failure (dmlc_shm_coll_last_error(NULL)).
 * ------------------------------------------------------------------ */
typedef struct DmlcShmColl DmlcShmColl;

DmlcShmColl* dmlc_shm_coll_create(const char* name, int rank, int world,
                                  long chunk_kb);

/* In-place chunked reduce-scatter over `count` elements of `dtype`:
 * within each internal chunk of n elements, this rank's slice
 * [n*rank/world, n*(rank+1)/world) is replaced by the `op`-fold of
 * every rank's values (fold order rank 0..world-1, so results are
 * bit-deterministic); bytes outside the slice are left untouched.
 * Returns 0, -2 on bad dtype/op, -1 on timeout/abort. */
int dmlc_shm_coll_reduce_scatter(DmlcShmColl* g, void* data, long count,
                                 int dtype, int op);

/* The gather half of the pair: each rank publishes its per-chunk slice
 * (the region reduce_scatter filled) and receives every other rank's,
 * so reduce_scatter followed by allgather leaves the full reduction in
 * `data` on every rank — bit-identical to dmlc_comm_allreduce's shm
 * path. */
int dmlc_shm_coll_allgather(DmlcShmColl* g, void* data, long count,
                            int dtype);

/* Chunked broadcast of `nbytes` from `root`'s buffer (in place). */
int dmlc_shm_coll_broadcast(DmlcShmColl* g, void* data, long nbytes,
                            int root);

/* Convenience: reduce_scatter + allgather. */
int dmlc_shm_coll_allreduce(DmlcShmColl* g, void* data, long count,
                            int dtype, int op);

/* Poison the group: every rank currently (or subsequently) blocked in
 * a collective returns -1 promptly instead of spinning to the timeout.
 * The elastic cascade for shm peers — a rank tearing down its TCP
 * links on WorldResized aborts the group so same-host peers wake too. */
void dmlc_shm_coll_abort(DmlcShmColl* g);

void dmlc_shm_coll_destroy(DmlcShmColl* g);

/* Last error on this group ("" if none); NULL queries the thread-local
 * reason a dmlc_shm_coll_create call returned NULL. */
const char* dmlc_shm_coll_last_error(const DmlcShmColl* g);

/* ------------------------------------------------------------------ *
 * Parameter-server KV data plane (the worker/server/scheduler role
 * model of the reference's PS path, tracker/dmlc_tracker/tracker.py:
 * 336-386 env contract).  Under `dmlc-submit --num-servers N` every
 * task runs the same binary: DMLC_ROLE selects the behavior, the
 * scheduler rendezvous rides DMLC_PS_ROOT_URI/PORT, and key vectors
 * shard over servers by key %% num_servers.  Push is SUM-aggregated
 * server-side; pull can wait for a minimum number of pushes on the
 * key (the PS clock), which is how workers synchronize an iteration.
 * ------------------------------------------------------------------ */
typedef struct DmlcKV DmlcKV;

enum {
  DMLC_KV_WORKER = 0,
  DMLC_KV_SERVER = 1,
  DMLC_KV_SCHEDULER = 2,
};

/* Role + rendezvous from the DMLC env contract.  Workers return ready
 * to push/pull; servers and the scheduler return ready for
 * dmlc_kv_serve().  NULL on failure (see dmlc_kv_last_error(NULL)). */
DmlcKV* dmlc_kv_init(void);

int dmlc_kv_role(const DmlcKV* kv);

/* Server: answer push/pull until every worker finalized.  Scheduler:
 * broker registration, then wait for the gang to finish.  Returns 0 on
 * clean completion. */
int dmlc_kv_serve(DmlcKV* kv);

/* Worker: SUM-push n doubles under `key` to its owning server. */
int dmlc_kv_push(DmlcKV* kv, long key, const double* val, long n);

/* Worker: read `key` (zeros if never pushed).  min_pushes > 0 blocks
 * until that many pushes have been aggregated on the key — pass the
 * worker count to read a full iteration's sum. */
int dmlc_kv_pull(DmlcKV* kv, long key, double* out, long n,
                 long min_pushes);

/* Worker: notify servers + scheduler this worker is done; all roles:
 * release sockets and free. */
void dmlc_kv_shutdown(DmlcKV* kv);

const char* dmlc_kv_last_error(const DmlcKV* kv);

#ifdef __cplusplus
}
#endif

#endif  /* DMLC_COLLECTIVE_H_ */
