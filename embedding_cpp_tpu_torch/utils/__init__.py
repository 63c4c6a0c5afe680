"""Runtime counters (`metrics`) and the GPU profiling helpers (`profiling`)."""
