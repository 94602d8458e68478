# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: gpu_mount.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fgpu_mount.proto\x12\tgpu_mount\"n\n\rAddGPURequest\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x0f\n\x07gpu_num\x18\x03 \x01(\x05\x12\x17\n\x0fis_entire_mount\x18\x04 \x01(\x08\x12\x0e\n\x06txn_id\x18\x05 \x01(\t\"\xb5\x01\n\x0e\x41\x64\x64GPUResponse\x12\x36\n\x06result\x18\x01 \x01(\x0e\x32&.gpu_mount.AddGPUResponse.AddGPUResult\x12\x12\n\ndevice_ids\x18\x02 \x03(\t\x12\x14\n\x0c\x64\x65vice_paths\x18\x03 \x03(\t\"A\n\x0c\x41\x64\x64GPUResult\x12\x0b\n\x07Success\x10\x00\x12\x13\n\x0fInsufficientGPU\x10\x01\x12\x0f\n\x0bPodNotFound\x10\x02\"e\n\x10RemoveGPURequest\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\r\n\x05uuids\x18\x03 \x03(\t\x12\r\n\x05\x66orce\x18\x04 \x01(\x08\x12\x0e\n\x06txn_id\x18\x05 \x01(\t\"\xb3\x01\n\x11RemoveGPUResponse\x12<\n\x06result\x18\x01 \x01(\x0e\x32,.gpu_mount.RemoveGPUResponse.RemoveGPUResult\x12\x11\n\tbusy_pids\x18\x02 \x03(\x05\"M\n\x0fRemoveGPUResult\x12\x0b\n\x07Success\x10\x00\x12\x0b\n\x07GPUBusy\x10\x01\x12\x0f\n\x0bPodNotFound\x10\x02\x12\x0f\n\x0bGPUNotFound\x10\x04\"7\n\x10GPUStatusRequest\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\"\xac\x01\n\x11GPUStatusResponse\x12.\n\x04gpus\x18\x01 \x03(\x0b\x32 .gpu_mount.GPUStatusResponse.GPU\x12\x12\n\nmount_type\x18\x02 \x01(\t\x1aS\n\x03GPU\x12\x11\n\tdevice_id\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65vice_path\x18\x02 \x01(\t\x12\x11\n\tslave_pod\x18\x03 \x01(\t\x12\x11\n\tbusy_pids\x18\x04 \x03(\x05\"\x16\n\x14GPUNodeStatusRequest\"\xd9\x01\n\x15GPUNodeStatusResponse\x12\x36\n\x04gpus\x18\x01 \x03(\x0b\x32(.gpu_mount.GPUNodeStatusResponse.NodeGPU\x12\x0c\n\x04node\x18\x02 \x01(\t\x1az\n\x07NodeGPU\x12\x11\n\tdevice_id\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65vice_path\x18\x02 \x01(\t\x12\r\n\x05state\x18\x03 \x01(\t\x12\x10\n\x08pod_name\x18\x04 \x01(\t\x12\x11\n\tnamespace\x18\x05 \x01(\t\x12\x13\n\x0b\x61\x63\x63\x65lerator\x18\x06 \x01(\t2\xbc\x02\n\x0fGPUMountService\x12?\n\x06\x41\x64\x64GPU\x12\x18.gpu_mount.AddGPURequest\x1a\x19.gpu_mount.AddGPUResponse\"\x00\x12H\n\tRemoveGPU\x12\x1b.gpu_mount.RemoveGPURequest\x1a\x1c.gpu_mount.RemoveGPUResponse\"\x00\x12H\n\tGPUStatus\x12\x1b.gpu_mount.GPUStatusRequest\x1a\x1c.gpu_mount.GPUStatusResponse\"\x00\x12T\n\rGPUNodeStatus\x12\x1f.gpu_mount.GPUNodeStatusRequest\x1a .gpu_mount.GPUNodeStatusResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gpu_mount_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ADDGPUREQUEST._serialized_start=30
  _ADDGPUREQUEST._serialized_end=140
  _ADDGPURESPONSE._serialized_start=143
  _ADDGPURESPONSE._serialized_end=324
  _ADDGPURESPONSE_ADDGPURESULT._serialized_start=259
  _ADDGPURESPONSE_ADDGPURESULT._serialized_end=324
  _REMOVEGPUREQUEST._serialized_start=326
  _REMOVEGPUREQUEST._serialized_end=427
  _REMOVEGPURESPONSE._serialized_start=430
  _REMOVEGPURESPONSE._serialized_end=609
  _REMOVEGPURESPONSE_REMOVEGPURESULT._serialized_start=532
  _REMOVEGPURESPONSE_REMOVEGPURESULT._serialized_end=609
  _GPUSTATUSREQUEST._serialized_start=611
  _GPUSTATUSREQUEST._serialized_end=666
  _GPUSTATUSRESPONSE._serialized_start=669
  _GPUSTATUSRESPONSE._serialized_end=841
  _GPUSTATUSRESPONSE_GPU._serialized_start=758
  _GPUSTATUSRESPONSE_GPU._serialized_end=841
  _GPUNODESTATUSREQUEST._serialized_start=843
  _GPUNODESTATUSREQUEST._serialized_end=865
  _GPUNODESTATUSRESPONSE._serialized_start=868
  _GPUNODESTATUSRESPONSE._serialized_end=1085
  _GPUNODESTATUSRESPONSE_NODEGPU._serialized_start=963
  _GPUNODESTATUSRESPONSE_NODEGPU._serialized_end=1085
  _GPUMOUNTSERVICE._serialized_start=1088
  _GPUMOUNTSERVICE._serialized_end=1404
# @@protoc_insertion_point(module_scope)
