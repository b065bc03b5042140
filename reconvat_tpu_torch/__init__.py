"""reconvat_tpu_torch: the PyTorch/CUDA port of reconvat_tpu.

It imports torch and never jax, nor any module of `reconvat_tpu`. Entry
points run on CUDA unless the caller passes `device="cpu"`. The serving
path (`serve.transcribe_batch` over `models.reconvat.ReconVAT`) runs two
hand-written CUDA kernels: the fused STFT+mel frontend (`ops/mel_kernel.py`,
`csrc/mel.cu`) and the banded-attention forward
(`ops/banded_attention_kernel.py`, `csrc/banded_attention.cu`). Notes are
decoded by the native decoder (`decode.py`, `csrc/note_extract.cpp`). The
transcription CLI is `python -m reconvat_tpu_torch.transcribe_files`.
"""
