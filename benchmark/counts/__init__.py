"""The yardstick's arithmetic, frozen under the benchmark: the H100's
peaks, each kernel's operations and bytes from its launch shape, the
profiler's kernel-name families and whole-step operation counts."""
