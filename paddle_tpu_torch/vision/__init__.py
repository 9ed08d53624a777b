"""Vision models of the port (``paddle_tpu/vision/``)."""
