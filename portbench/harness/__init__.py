"""The benchmark's harness: the run's inputs, the trace and its reduction,
the roofline counts and what every output check shares."""
