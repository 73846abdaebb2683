"""The port's `edl` command-line client (counterpart of elasticdl_tpu/client/)."""
