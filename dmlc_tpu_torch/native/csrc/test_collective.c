/* C test program for the port's dmlc_collective ABI
 * (dmlc_tpu_torch/native/csrc/dmlc_collective.{cc,h}); run under
 *   python -m dmlc_tpu_torch.tracker.submit --cluster local \
 *       --num-workers N -- ./test_collective
 * Exercises allreduce (sum/max/min, f32/i64), broadcast from a nonzero
 * root, and allgather; exits nonzero on any mismatch.  A copy of the JAX
 * package's program (dmlc_tpu/cpp/test_collective.c);
 * tests/test_torch_sanitizers.py runs it under AddressSanitizer and
 * UBSan with 4 workers, DMLC_COLL_SHM=1 and =0.  It is not part of the
 * shm collective library (native/shm_collective.py names its source).
 *
 * With argv[1] == "bench": allreduce bus-bandwidth microbench (1KB /
 * 1MB / 64MB f32 payloads + a 1MB allgather); rank 0 prints one JSON
 * line per size on stdout.  busbw follows the NCCL convention
 * 2·(n-1)/n · algbw. */
#define _POSIX_C_SOURCE 199309L  /* clock_gettime under -std=c99 */
#include "dmlc_collective.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define CHECK(cond, msg)                                   \
  do {                                                     \
    if (!(cond)) {                                         \
      fprintf(stderr, "FAIL rank=%d: %s\n", rank, msg);    \
      return 1;                                            \
    }                                                      \
  } while (0)

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

static int run_bench(DmlcComm* c) {
  int rank = dmlc_comm_rank(c);
  int world = dmlc_comm_world_size(c);
  const long sizes[] = {1 << 10, 1 << 20, 64l << 20};
  const int reps[] = {50, 20, 4};
  size_t si;
  for (si = 0; si < sizeof sizes / sizeof sizes[0]; ++si) {
    const long nbytes = sizes[si];
    const long count = nbytes / 4;
    float* buf = (float*)malloc(nbytes);
    long i;
    for (i = 0; i < count; ++i) buf[i] = 1.0f;
    /* warmup + barrier-ish sync */
    CHECK(dmlc_comm_allreduce(c, buf, count, DMLC_F32, DMLC_SUM) == 0,
          "bench warmup");
    double t0 = now_s();
    int r;
    for (r = 0; r < reps[si]; ++r) {
      CHECK(dmlc_comm_allreduce(c, buf, count, DMLC_F32, DMLC_SUM) == 0,
            "bench allreduce");
    }
    double dt = now_s() - t0;
    if (rank == 0) {
      double algbw = nbytes * (double)reps[si] / dt / 1e6;
      double busbw = algbw * 2.0 * (world - 1) / world;
      /* aggregate bytes the tree actually moves through the transport:
       * every non-root sends nbytes up and receives nbytes down */
      double linkbw = algbw * 2.0 * (world - 1);
      printf("{\"op\": \"allreduce\", \"bytes\": %ld, \"algbw_MBps\": %.1f, "
             "\"busbw_MBps\": %.1f, \"aggregate_link_MBps\": %.1f, "
             "\"world\": %d}\n",
             nbytes, algbw, busbw, linkbw, world);
      fflush(stdout);
    }
    free(buf);
  }
  /* allgather 1MB per rank */
  {
    const long nbytes = 1 << 20;
    char* in = (char*)malloc(nbytes);
    char* out = (char*)malloc(nbytes * world);
    memset(in, (char)rank, nbytes);
    CHECK(dmlc_comm_allgather(c, in, nbytes, out) == 0, "bench allgather");
    double t0 = now_s();
    int r;
    const int R = 10;
    for (r = 0; r < R; ++r)
      CHECK(dmlc_comm_allgather(c, in, nbytes, out) == 0, "bench allgather");
    double dt = now_s() - t0;
    int i;
    for (i = 0; i < world; ++i)
      CHECK(out[i * nbytes] == (char)i, "bench allgather value");
    if (rank == 0) {
      double algbw = nbytes * (double)world * R / dt / 1e6;
      double busbw = algbw * (world - 1) / world;
      printf("{\"op\": \"allgather\", \"bytes\": %ld, \"algbw_MBps\": %.1f, "
             "\"busbw_MBps\": %.1f, \"world\": %d}\n",
             nbytes, algbw, busbw, world);
      fflush(stdout);
    }
    free(in);
    free(out);
  }
  return 0;
}

/* Randomized mixed-op stress: every rank derives the SAME op/size/root
 * sequence from a broadcast seed, so the gang issues identical
 * collectives while sizes span 1 element .. ~1.5 MB — many shm chunks,
 * slot reuse across op types, announce-slot parity flips, odd element
 * counts.  Catches generation-discipline bugs a fixed sequence cannot. */
static int run_stress(DmlcComm* c, int rounds) {
  int rank = dmlc_comm_rank(c);
  int world = dmlc_comm_world_size(c);
  unsigned long seed = 0;
  if (rank == 0) seed = 0x9e3779b9UL ^ (unsigned long)world;
  CHECK(dmlc_comm_broadcast(c, &seed, sizeof seed, 0) == 0, "seed bcast");
  double* buf = (double*)malloc((200 * 1000 + 8) * sizeof(double));
  double* out = (double*)malloc((200 * 1000 + 8) * sizeof(double) * world);
  int r;
  for (r = 0; r < rounds; ++r) {
    seed = seed * 6364136223846793005UL + 1442695040888963407UL;
    const long n = 1 + (long)((seed >> 16) % 200000); /* elems */
    const int kind = (int)((seed >> 40) % 3);
    long i;
    if (kind == 0) { /* f64 sum allreduce */
      for (i = 0; i < n; ++i) buf[i] = (double)(i % 13) + rank;
      CHECK(dmlc_comm_allreduce(c, buf, n, DMLC_F64, DMLC_SUM) == 0,
            "stress allreduce rc");
      for (i = 0; i < n; i += 997) {
        double want = world * (double)(i % 13) + world * (world - 1) / 2.0;
        CHECK(fabs(buf[i] - want) < 1e-9, "stress allreduce value");
      }
    } else if (kind == 1) { /* broadcast from a rotating root */
      const int root = (int)((seed >> 8) % world);
      for (i = 0; i < n; ++i)
        buf[i] = rank == root ? (double)((i * 7 + r) % 101) : -1.0;
      CHECK(dmlc_comm_broadcast(c, buf, n * 8, root) == 0,
            "stress broadcast rc");
      for (i = 0; i < n; i += 997)
        CHECK(buf[i] == (double)((i * 7 + r) % 101),
              "stress broadcast value");
    } else { /* allgather */
      const long nb = (n % 4096) + 1;
      for (i = 0; i < nb; ++i) buf[i] = rank * 1000.0 + (double)(i % 7);
      CHECK(dmlc_comm_allgather(c, buf, nb * 8, out) == 0,
            "stress allgather rc");
      for (i = 0; i < world; ++i) {
        long j;
        for (j = 0; j < nb; j += 97)  /* sample block interiors too */
          CHECK(out[i * nb + j] == i * 1000.0 + (double)(j % 7),
                "stress allgather value");
      }
    }
  }
  free(buf);
  free(out);
  if (rank == 0) {
    printf("stress OK rounds=%d world=%d\n", rounds, world);
    fflush(stdout);
  }
  return 0;
}

int main(int argc, char** argv) {
  DmlcComm* c = dmlc_comm_init();
  if (c == NULL) {
    fprintf(stderr, "FAIL: dmlc_comm_init returned NULL\n");
    return 1;
  }
  int rank = dmlc_comm_rank(c);
  int world = dmlc_comm_world_size(c);
  CHECK(rank >= 0 && world >= 1, "bad rank/world");

  if (argc > 1 && strcmp(argv[1], "stress") == 0) {
    int rc = run_stress(c, argc > 2 ? atoi(argv[2]) : 60);
    dmlc_comm_shutdown(c);
    return rc;
  }
  if (argc > 1 && strcmp(argv[1], "bench") == 0) {
    int rc = run_bench(c);
    dmlc_comm_shutdown(c);
    return rc;
  }

  /* allreduce sum: rank+1 summed over ranks = world*(world+1)/2 */
  float v[8];
  int i;
  for (i = 0; i < 8; ++i) v[i] = (float)(rank + 1);
  CHECK(dmlc_comm_allreduce(c, v, 8, DMLC_F32, DMLC_SUM) == 0,
        "allreduce sum rc");
  for (i = 0; i < 8; ++i)
    CHECK(fabsf(v[i] - world * (world + 1) / 2.0f) < 1e-4, "allreduce sum");

  /* allreduce max/min on i64 */
  long long w[3];
  for (i = 0; i < 3; ++i) w[i] = (long long)rank * 10 + i;
  CHECK(dmlc_comm_allreduce(c, w, 3, DMLC_I64, DMLC_MAX) == 0,
        "allreduce max rc");
  for (i = 0; i < 3; ++i)
    CHECK(w[i] == (long long)(world - 1) * 10 + i, "allreduce max");
  for (i = 0; i < 3; ++i) w[i] = (long long)rank * 10 + i;
  CHECK(dmlc_comm_allreduce(c, w, 3, DMLC_I64, DMLC_MIN) == 0,
        "allreduce min rc");
  for (i = 0; i < 3; ++i) CHECK(w[i] == i, "allreduce min");

  /* broadcast from the last rank */
  int root = world - 1;
  double b[4];
  for (i = 0; i < 4; ++i) b[i] = (rank == root) ? 42.5 + i : -1.0;
  CHECK(dmlc_comm_broadcast(c, b, sizeof b, root) == 0, "broadcast rc");
  for (i = 0; i < 4; ++i) CHECK(b[i] == 42.5 + i, "broadcast value");

  /* allgather rank-stamped blocks */
  int blk[2] = {rank, rank * rank};
  int* all = (int*)malloc(sizeof blk * world);
  CHECK(dmlc_comm_allgather(c, blk, sizeof blk, all) == 0, "allgather rc");
  for (i = 0; i < world; ++i) {
    CHECK(all[2 * i] == i && all[2 * i + 1] == i * i, "allgather value");
  }
  free(all);

  /* large chunked allreduce: exercises the streaming pipeline */
  {
    long n = (8 << 20) / 4;
    float* big = (float*)malloc(n * 4);
    long j;
    for (j = 0; j < n; ++j) big[j] = (float)((j % 97) + rank);
    CHECK(dmlc_comm_allreduce(c, big, n, DMLC_F32, DMLC_SUM) == 0,
          "big allreduce rc");
    for (j = 0; j < n; j += 1009) {
      float want = world * (float)(j % 97) + world * (world - 1) / 2.0f;
      CHECK(fabsf(big[j] - want) < 1e-2, "big allreduce value");
    }
    free(big);
  }

  /* large broadcast from a nonzero root: multi-chunk relay (shm slot
   * double-buffering / TCP ancestor-path streaming) */
  {
    long nb = 3 << 20;
    char* bb = (char*)malloc(nb);
    long j;
    if (rank == root) {
      for (j = 0; j < nb; ++j) bb[j] = (char)((j * 31 + 7) & 0xff);
    } else {
      memset(bb, 0, nb);
    }
    CHECK(dmlc_comm_broadcast(c, bb, nb, root) == 0, "big broadcast rc");
    for (j = 0; j < nb; j += 4099)
      CHECK(bb[j] == (char)((j * 31 + 7) & 0xff), "big broadcast value");
    free(bb);
  }

  /* large allgather: exercises the duplex ring path */
  {
    long nb = 512 << 10;
    char* in2 = (char*)malloc(nb);
    char* out2 = (char*)malloc(nb * world);
    memset(in2, rank + 1, nb);
    CHECK(dmlc_comm_allgather(c, in2, nb, out2) == 0, "big allgather rc");
    for (i = 0; i < world; ++i)
      CHECK(out2[(long)i * nb] == (char)(i + 1) &&
                out2[(long)i * nb + nb - 1] == (char)(i + 1),
            "big allgather value");
    free(in2);
    free(out2);
  }

  {
    char msg[64];
    snprintf(msg, sizeof msg, "rank %d/%d: collective ABI OK", rank, world);
    dmlc_comm_log(c, msg);
  }
  dmlc_comm_shutdown(c);
  return 0;
}
