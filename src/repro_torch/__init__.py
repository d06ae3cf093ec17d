"""PyTorch/CUDA port of the BLMAC filter-bank system, for one NVIDIA H100.

A second package beside the JAX reference `repro`, which it never
imports: the compiler (`repro_torch.compiler`) and the numpy oracles
are its own copies, with the reference's content keys and file formats,
and its four kernels — the bank kernel, the pulse-specialized kernel, the
combine fold of CSE-optimized banks and the pulse-code matmul — are
written by hand in CUDA C++ for Hopper (`repro_torch.kernels`, sources under
``kernels/csrc/``), built with ``nvcc`` at first use.

Layout (mirrors `repro`):

  core/      CSD codec, §3.2 quantizer, durable-file helpers, the
             dispatch cost model
  compiler/  compile_bank → BlmacProgram, schedules, cse_pass, TailSnapshot
  filters/   filter design, sweep bank, oracles, FilterBankEngine
  kernels/   blmac_fir / blmac_fir_bank, the dispatch planner, the CUDA
             kernels and their plain PyTorch versions, the nvcc build
  configs/   the ten language-model architectures (the reference's
             registry)
  nn/        the language models in plain PyTorch (the reference's LM
             path runs no Pallas kernel); serving.ServeEngine serves them
  training/  the optimizers (AdamW, Adafactor, in place) and the train
             step; data/ the synthetic token pipeline; checkpoint/
             keep-k checkpoints in the reference's format;
             distributed.TrainLoop the fault-tolerant loop

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
