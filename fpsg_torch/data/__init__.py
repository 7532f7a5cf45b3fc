"""Host/device data helpers of the port (counterpart of ``fpsg_tpu.data``)."""
