"""Weight interchange of the port (counterpart of ``fpsg_tpu.io``)."""
