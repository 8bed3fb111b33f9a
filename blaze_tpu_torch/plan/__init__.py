"""Plan wire format: plan.proto, its generated module and the serde.

`plan_pb2.py` is a byte-identical copy of the JAX package's
`blaze_tpu/plan/plan_pb2.py`. Both register the file `plan.proto`,
package `blaze_tpu.plan`, in protobuf's default descriptor pool;
identical serialized descriptors load side by side in one process (a
test imports both packages). A copy that diverged would clash there, so
regenerate both from one plan.proto or neither.
"""
