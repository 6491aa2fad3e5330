"""Self-contained ONNX protobuf bindings.

The onnx python package is not available in this image;
`paddle_tpu_onnx_pb2` is generated (protoc) from the bundled
`paddle_tpu_onnx.proto`, a subset of the official schema with upstream
field numbers/enums, so serialized models are valid ONNX files. The
proto file and package are deliberately NOT named `onnx`: the real onnx
package registers `onnx.proto` into protobuf's default descriptor pool,
and a second registration with different bytes raises — the rename
keeps both importable in one process (wire format depends only on
field numbers). Regenerate with:
    protoc --python_out=. paddle_tpu_onnx.proto
"""
from . import paddle_tpu_onnx_pb2 as onnx_pb2  # noqa: F401
