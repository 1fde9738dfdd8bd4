"""The interactive chat demo of the port (``python -m
videotgb_torch.demo.app``)."""
