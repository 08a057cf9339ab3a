"""The plain references the benchmark judges the program against. They
import nothing of the program and nothing of JAX."""
