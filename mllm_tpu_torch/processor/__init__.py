"""Image preprocessing and the Qwen2-VL processor: copies of `mllm_tpu.processor`
(numpy on the host) with torch versions of its device-side steps."""
