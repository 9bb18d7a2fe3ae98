"""Launching the PyTorch port: device meshes for the multi-device
executors (:mod:`repro_torch.launch.mesh`) and the command-line entry points
(``python -m repro_torch.launch.serve``)."""
