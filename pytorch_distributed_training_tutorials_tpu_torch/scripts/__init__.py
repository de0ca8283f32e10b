"""The repo's measurement scripts, as modules of the port (``python -m
pytorch_distributed_training_tutorials_tpu_torch.scripts.<name>``):
:mod:`.profile_step` (where a ResNet-18 train step's device time goes),
:mod:`.profile_decode` (the same for a 1b int8 decode chain),
:mod:`.flight_view` (``graft-flightlog/v1`` dumps as timelines) and
:mod:`.launch_overhead_probe` (a launch's fixed cost against per-op time).
"""
