# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: serve_rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fserve_rpc.proto\x12\x0craytpu.serve\"~\n\x0cServeRequest\x12\x0b\n\x03\x61pp\x18\x01 \x01(\t\x12\x12\n\ndeployment\x18\x02 \x01(\t\x12\x0e\n\x06method\x18\x03 \x01(\t\x12\x14\n\x0cjson_payload\x18\x04 \x01(\x0c\x12\x14\n\x0c\x61\x66\x66inity_key\x18\x05 \x01(\t\x12\x11\n\ttimeout_s\x18\x06 \x01(\x01\"~\n\nServeReply\x12/\n\x06status\x18\x01 \x01(\x0e\x32\x1f.raytpu.serve.ServeReply.Status\x12\x13\n\x0bjson_result\x18\x02 \x01(\x0c\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"\x1b\n\x06Status\x12\x06\n\x02OK\x10\x00\x12\t\n\x05\x45RROR\x10\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'serve_rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SERVEREQUEST._serialized_start=33
  _SERVEREQUEST._serialized_end=159
  _SERVEREPLY._serialized_start=161
  _SERVEREPLY._serialized_end=287
  _SERVEREPLY_STATUS._serialized_start=260
  _SERVEREPLY_STATUS._serialized_end=287
# @@protoc_insertion_point(module_scope)
