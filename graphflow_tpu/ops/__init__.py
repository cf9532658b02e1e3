"""Differentiable op library (L2/L3): the JAX equivalents of the reference's
~70 op headers.  See SURVEY.md 2.3-2.4 for the full inventory mapping."""

from graphflow_tpu.ops.activations import (
    identity, sigmoid, tanh, relu, leaky_relu, softmax, dropout, masking,
    norm3d,
)
from graphflow_tpu.ops.linalg import (
    add, subtract, multiply, inner_product, outer_product, transpose,
    scalar_matmul, mat_vec_mul, matmul, mat_tensor_mul, tensor_mat_mul,
    tensor_mul, tensor4d_tensor3d_mul, custom_matmul_tensor,
    vector_broadcast_mat, mat_broadcast_mat, vector_add_matrix,
    vector_add_tensor, linear_gram,
)
from graphflow_tpu.ops.reductions import (
    sum_components, sum_vectors, average_vectors, sum_matrices, sum_tensor3d,
    sum_rows, shrink_matrix, shrink_tensor, concat, matrix_concat,
    tensor3d_concat, tensor4d_concat, stack_tensor3d, shuffle_matrix,
    sort_vector, kmax, vertex_representation, risi_layer_1d, risi_layer_2d,
    risi_layer_3d, reshape2d, reshape3d, reshape4d,
)
from graphflow_tpu.ops.conv import conv1d, conv2d, max_pool2d, avg_pool2d
from graphflow_tpu.ops.losses import (
    squared_loss, log_loss, l1_regularization, l2_regularization,
)
from graphflow_tpu.ops.contractions import (
    risi_contraction_4, risi_contraction_10, risi_contraction_18,
    risi_contraction_18_spec, risi_contraction_18_batched,
    risi_contraction_18_dropout, risi_contraction_50, dropout_case_mask,
)
