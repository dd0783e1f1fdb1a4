"""Measurement tools of the port, each a counterpart of a tool of the JAX
package that carried a Pallas kernel:

  probe_bf16_ops  T1: which bfloat16 ops K1's compiler lowers natively on
                  the card, and whether they round as the plain version
  bench_dtype     T2: a tail-shaped op chain timed in float32 and bfloat16
  flopcount       T3: the cost walker the roofline bounds come from, and
                  its fixture kernel (csrc/fixture.cu)

Each runs on a CUDA card as `python -m shaderflow_tpu_torch.tools.<name>`;
importing them needs neither triton nor a card.
"""
