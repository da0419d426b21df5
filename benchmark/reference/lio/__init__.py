"""A frozen copy of the port's plain LIO path (dliom_tpu_torch), run eagerly with its kernels' plain versions."""
