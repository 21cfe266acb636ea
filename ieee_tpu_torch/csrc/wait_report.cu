// The host's side of the bounded mbarrier waits of the Hopper kernels
// (sm90_gemm.cuh `mbar_wait`): a wait that runs past its bound writes a
// WaitReport into page-locked host memory and traps, and the launch fails;
// the report is read here, where a failed context does not matter, and
// printed by ops/_build.py when the process exits.

#include <cstdio>

#include "wait_report.cuh"

// writes the report of a timed-out wait into buf (len bytes, terminated)
// and returns 1, or returns 0 if no wait of this process has timed out (or
// no kernel that waits has been launched); makes no CUDA call
extern "C" int ieee_wait_report(char* buf, int len) {
  const volatile sm90::WaitReport* r = sm90::wait_report_host();
  if (r == nullptr || !r->set || len <= 0) return 0;
  snprintf(buf, len,
           "sm90 mbarrier wait timed out: block (%u, %u, %u) thread %u, "
           "barrier at shared 0x%x, parity %u",
           r->block[0], r->block[1], r->block[2], r->thread, r->bar,
           r->parity);
  return 1;
}
