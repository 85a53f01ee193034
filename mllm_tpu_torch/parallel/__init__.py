"""The parallel axes over `torch.distributed`: tensor and data parallelism
(`sharding`, `heads`), the GPipe pipeline (`pipeline`), experts (`expert`),
sequence parallelism (`ring_attention`, `ulysses`), multi-host helpers
(`multihost`), the collectives they share (`comm`) and the dry run
(`dryrun`). Counterpart of `mllm_tpu/parallel/`."""
