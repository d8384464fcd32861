"""Shared constants: artifact names, file prefixes, numeric defaults.

The on-disk artifact names match the reference implementation
(kronfluence/utils/constants.py) bit-for-bit so factor/score directories are
interchangeable between the two frameworks.
"""

from typing import Dict, List, Tuple, Union

import numpy as np

# Type aliases (factor state pytrees map module-name -> artifact-name -> array).
FACTOR_TYPE = Dict[str, Dict[str, np.ndarray]]
PARTITION_TYPE = Tuple[int, int]
SCORE_TYPE = Dict[str, np.ndarray]

# File naming conventions (identical to reference).
FACTOR_SAVE_PREFIX = "factors_"
SCORE_SAVE_PREFIX = "scores_"
FACTOR_ARGUMENTS_NAME = "factor"
SCORE_ARGUMENTS_NAME = "score"

# Scale for the heuristic damping term (reference: utils/constants.py:22).
HEURISTIC_DAMPING_SCALE = 0.1

# Covariance artifacts.
ACTIVATION_COVARIANCE_MATRIX_NAME = "activation_covariance"
GRADIENT_COVARIANCE_MATRIX_NAME = "gradient_covariance"
NUM_ACTIVATION_COVARIANCE_PROCESSED = "num_activation_covariance_processed"
NUM_GRADIENT_COVARIANCE_PROCESSED = "num_gradient_covariance_processed"

COVARIANCE_FACTOR_NAMES: List[str] = [
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
]

# Eigendecomposition artifacts.
ACTIVATION_EIGENVECTORS_NAME = "activation_eigenvectors"
ACTIVATION_EIGENVALUES_NAME = "activation_eigenvalues"
GRADIENT_EIGENVECTORS_NAME = "gradient_eigenvectors"
GRADIENT_EIGENVALUES_NAME = "gradient_eigenvalues"

EIGENDECOMPOSITION_FACTOR_NAMES: List[str] = [
    ACTIVATION_EIGENVECTORS_NAME,
    ACTIVATION_EIGENVALUES_NAME,
    GRADIENT_EIGENVECTORS_NAME,
    GRADIENT_EIGENVALUES_NAME,
]

# Lambda (EK-FAC eigenvalue-correction) artifacts.
LAMBDA_MATRIX_NAME = "lambda_matrix"
NUM_LAMBDA_PROCESSED = "num_lambda_processed"

LAMBDA_FACTOR_NAMES: List[str] = [LAMBDA_MATRIX_NAME, NUM_LAMBDA_PROCESSED]

# Score artifacts.
PAIRWISE_SCORE_MATRIX_NAME = "pairwise_score_matrix"
SELF_SCORE_VECTOR_NAME = "self_score_vector"

# Dictionary key used for scores summed over all modules.
ALL_MODULE_NAME = "all_modules"

# dtype used on the host when computing reciprocals of eigenvalues
# (reference: LAMBDA_DTYPE = torch.float64).
LAMBDA_DTYPE = np.float64
