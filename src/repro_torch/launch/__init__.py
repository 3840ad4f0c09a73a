"""Meshes and their sharding rules (``mesh``, ``sharding``), the shape
stand-ins of every model input (``specs``), and the training and serving
drivers (``python -m repro_torch.launch.train`` / ``.serve``)."""
