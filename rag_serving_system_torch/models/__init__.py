"""e5 encoder and Qwen2 decoder as functions on dicts of tensors, in the JAX
package's parameter layout. Architecture configs are the JAX package's own
(`rag_serving_system_tpu.models.configs`, which imports no jax)."""
