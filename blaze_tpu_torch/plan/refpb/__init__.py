"""Generated bindings for the REFERENCE engine's wire format.

`refplan_pb2.py` is a byte-identical copy of the JAX package's
`blaze_tpu/plan/refpb/refplan_pb2.py`: protoc output from the
reference's plan-serde contract (the `plan.protobuf` package:
PhysicalPlanNode plan.proto:26-43, TaskDefinition :508-513). Both copies
register the file `refplan.proto` in protobuf's default descriptor pool;
identical serialized descriptors load side by side in one process (a
test imports both packages), a copy that diverged would clash. So
regenerate both from one proto or neither:

    protoc --python_out=<package>/plan/refpb -I <dir> refplan.proto

The port's own schema (`plan/plan.proto`) stays the native format; this
package lets a deployment that speaks the reference's protocol (the
Spark extension tier emitting TaskDefinition bytes over JNI,
NativeRDD.scala:41-44) drive the port unchanged - see
`blaze_tpu_torch.plan.refcompat` for the decoder.
"""

from blaze_tpu_torch.plan.refpb import refplan_pb2  # noqa: F401
