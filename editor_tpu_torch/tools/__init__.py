"""The port's measuring scripts, run on a CUDA device, and its checkpoint
converter (``convert_checkpoint``)."""
