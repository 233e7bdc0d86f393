"""The benchmark's plain reference: a frozen copy of the math of the two
segmentation models the benchmark runs (BEiT-Adapter with Mask2Former,
ViT-Adapter with UperNet and the FCN auxiliary head), their losses and
AdamW with layer decay, in plain PyTorch. Multi-scale deformable attention
and point sampling are `F.grid_sample`, attention is softmax(q k^T) v, the
matching is the epsilon auction on tensors. It imports nothing of the
program it checks: it is built from the configuration and handed the same
state dict and inputs."""
