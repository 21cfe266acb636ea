// The record of a Hopper kernel's mbarrier wait that ran past its bound
// (sm90_gemm.cuh `mbar_wait`), kept in page-locked host memory mapped into
// the device, so the host can read it after the launch has failed.
#pragma once

#include <cstdint>

namespace sm90 {

struct WaitReport {
  uint32_t set, block[3], thread, bar, parity;
};

// the process's record (one for every unit: an inline function's static),
// null until a unit's first launch allocates it
inline WaitReport*& wait_report_host() {
  static WaitReport* report = nullptr;
  return report;
}

}  // namespace sm90
