"""The plain reference: ALIKED, its keypoint selection, LightGlue, the
training loss and the AdamW chain, written again in plain PyTorch from the
model's equations. It imports nothing of the port. Every product runs in
float32 with TF32 off; where the configuration states that a product runs
in bfloat16, its operands are rounded to bfloat16 first (``precision.py``),
so the reference computes what the configuration states and no more."""
