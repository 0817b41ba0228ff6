"""Plain float32 references of the benchmark's model families, one module a
family (``dense``, ``ssm``), each ``forward(spec, params, tokens,
positions, precision, layer_hook)``.  They import torch alone: nothing of
the program, whose outputs they only judge, and work its cache and state
out again from the inputs.  ``precision="fp8"`` is the control: every
product's inputs rounded to float8 e4m3 with a scale a row, the step below
the bfloat16 the configurations state."""
