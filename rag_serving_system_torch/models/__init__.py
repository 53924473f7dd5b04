"""e5 encoder and Qwen2 decoder as functions on dicts of tensors, in the JAX
package's parameter layout, with the port's own copies of the architecture
configs (`configs.py`) and the hashing tokenizer (`tokenizer.py`)."""
