"""Thin alias of the unified launcher (the reference's one main per
algorithm): equivalent to ``--algorithm crosssilo_fednas``."""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(sys.argv[1:], default_algorithm="crosssilo_fednas")
