"""Plain float32 references of the benchmark's configurations.

Written from the published model descriptions in plain PyTorch: they
import nothing of the program, and take only the weights and inputs that
the benchmark draws.  Matrix products run with TF32 off.  ``mode="fp8"``
rounds every matrix product's operands to float8 e4m3 (per-tensor scales
for weights, per-row for activations, attention's included), the
precision below the configurations' bfloat16: the control that a
comparison has to fail; ``mode="fp8_attn"`` rounds attention's alone
(:data:`bench.reference.common.MODES`)."""
