"""The plain fp32 PyTorch reference of the sparse LM that decides a run's
``correct``. It imports nothing of the port."""
