"""Names of the device operations of each layer, as lower-case pieces of
the kernel names the profiler records (`chip_smoke.py:KERNEL_GROUPS`)."""

MEL = ("mel_fft_kernel",)
ATTN_FWD = ("banded_attention_fwd",)
ATTN_BWD = ("bwd_partials", "bwd_overlap_add", "bwd_drel_sum")
ATTN_BWD_FIRST = ("bwd_partials",)   # one launch per backward call
CONV_BN = ("conv", "cudnn", "implicit", "dgrad", "wgrad", "fprop", "fft",
           "gemm_cf32", "pointwise_mult_and_sum_complex", "bn_fw", "bn_bw",
           "batch_norm")
