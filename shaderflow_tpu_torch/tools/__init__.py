"""Measurement tools of the port: the counterparts of the three tools of
the JAX package that carried a Pallas kernel, and a reader of the port's
own kernels:

  probe_bf16_ops  T1: which bfloat16 ops K1's compiler lowers natively on
                  the card, and whether they round as the plain version
  bench_dtype     T2: a tail-shaped op chain timed in float32 and bfloat16
                  (its kernel csrc/chain.cu, packed bf16x2 in bfloat16)
  flopcount       T3: the cost walker the roofline bounds come from, and
                  its fixture kernel (csrc/fixture.cu)
  sass            registers, spills and SASS of the CUDA C++ kernels
  watch           witnesses that host code does no work on the card

Each runs on a CUDA card as `python -m shaderflow_tpu_torch.tools.<name>`;
importing them needs neither triton nor a card.
"""
