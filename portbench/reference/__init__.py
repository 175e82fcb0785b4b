"""The plain reference the benchmark holds the port to.

Plain PyTorch in float64, from the run's inputs alone: the points, labels,
probes and indices the benchmark made from the seed. It imports nothing of
the port and nothing of JAX, and works out again everything the port
derives: the kNN graph, the Laplacian coefficients, the Matérn precision
and its noisy composition, the marginal-likelihood estimator with its
gradient, the outputscale normalization, and the posterior from a basis.

``precision`` selects how the block operator's coefficients and operand are
stored in each apply: "f64" (the reference), or a lower one for the control
runs ("fp8": e4m3 with one scale per tensor and per operand column;
"tf32": 10 mantissa bits; "bf16").
"""
