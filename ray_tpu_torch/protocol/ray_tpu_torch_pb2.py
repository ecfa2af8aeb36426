# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ray_tpu_torch.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13ray_tpu_torch.proto\x12\x16ray_tpu_torch.protocol"\xce\x02\n\x0eObjectLocation\x12\x13\n\x06inline\x18\x01 \x01(\x0cH\x00\x88\x01\x01\x12\x15\n\x08shm_name\x18\x02 \x01(\tH\x01\x88\x01\x01\x12\x19\n\x0cspilled_path\x18\x03 \x01(\tH\x02\x88\x01\x01\x12\x0c\n\x04size\x18\x04 \x01(\x04\x12\x10\n\x08is_error\x18\x05 \x01(\x08\x12\x0f\n\x07node_id\x18\x06 \x01(\t\x12\x17\n\nfetch_host\x18\x07 \x01(\tH\x03\x88\x01\x01\x12\x12\n\nfetch_port\x18\x08 \x01(\r\x12\x17\n\narena_path\x18\t \x01(\tH\x04\x88\x01\x01\x12\x11\n\tarena_off\x18\n \x01(\x04\x12\x16\n\tarena_key\x18\x0b \x01(\x0cH\x05\x88\x01\x01B\t\n\x07_inlineB\x0b\n\t_shm_nameB\x0f\n\r_spilled_pathB\r\n\x0b_fetch_hostB\r\n\x0b_arena_pathB\x0c\n\n_arena_key"\xad\x06\n\x08TaskSpec\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x12\n\x05fn_id\x18\x03 \x01(\x0cH\x00\x88\x01\x01\x12\x16\n\targs_blob\x18\x04 \x01(\x0cH\x01\x88\x01\x01\x12\x15\n\x08args_oid\x18\x05 \x01(\x0cH\x02\x88\x01\x01\x12\x0f\n\x07dep_ids\x18\x06 \x03(\x0c\x12\x13\n\x0bpinned_refs\x18\x07 \x03(\x0c\x12\x12\n\nowned_oids\x18\x08 \x03(\x0c\x12\x12\n\nreturn_ids\x18\t \x03(\x0c\x12\x13\n\x0bnum_returns\x18\n \x01(\x05\x12B\n\tresources\x18\x0b \x03(\x0b2/.ray_tpu_torch.protocol.TaskSpec.ResourcesEntry\x12 \n\x13scheduling_strategy\x18\x0c \x01(\x0cH\x03\x88\x01\x01\x12\x14\n\x0cretries_left\x18\r \x01(\x05\x12\x15\n\x08actor_id\x18\x0e \x01(\x0cH\x04\x88\x01\x01\x12\x18\n\x0bmethod_name\x18\x0f \x01(\tH\x05\x88\x01\x01\x12\x19\n\x11is_actor_creation\x18\x10 \x01(\x08\x12\x14\n\x0cmax_restarts\x18\x11 \x01(\x05\x12\x18\n\x10max_task_retries\x18\x12 \x01(\x05\x12\x17\n\nactor_name\x18\x13 \x01(\tH\x06\x88\x01\x01\x12\x18\n\x0bruntime_env\x18\x14 \x01(\x0cH\x07\x88\x01\x01\x12\x17\n\x0fmax_concurrency\x18\x15 \x01(\x05\x12\x1f\n\x17release_cpu_after_start\x18\x16 \x01(\x08\x12\x1b\n\x0eparent_task_id\x18\x17 \x01(\x0cH\x08\x88\x01\x01\x12\x12\n\x05extra\x18\x18 \x01(\x0cH\t\x88\x01\x01\x1a0\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x028\x01B\x08\n\x06_fn_idB\x0c\n\n_args_blobB\x0b\n\t_args_oidB\x16\n\x14_scheduling_strategyB\x0b\n\t_actor_idB\x0e\n\x0c_method_nameB\r\n\x0b_actor_nameB\x0e\n\x0c_runtime_envB\x11\n\x0f_parent_task_idB\x08\n\x06_extra"F\n\x06Submit\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12.\n\x04spec\x18\x02 \x01(\x0b2 .ray_tpu_torch.protocol.TaskSpec"<\n\x0bSubmitBatch\x12-\n\x05items\x18\x01 \x03(\x0b2\x1e.ray_tpu_torch.protocol.Submit"L\n\x08LocEntry\x12\x0b\n\x03oid\x18\x01 \x01(\x0c\x123\n\x03loc\x18\x02 \x01(\x0b2&.ray_tpu_torch.protocol.ObjectLocation"\x86\x01\n\x07Execute\x12.\n\x04spec\x18\x01 \x01(\x0b2 .ray_tpu_torch.protocol.TaskSpec\x122\n\x08dep_locs\x18\x02 \x03(\x0b2 .ray_tpu_torch.protocol.LocEntry\x12\x17\n\x07gpu_ids\x18\x03 \x03(\x05R\x06gpuIds"`\n\tSealEntry\x12\x0b\n\x03oid\x18\x01 \x01(\x0c\x123\n\x03loc\x18\x02 \x01(\x0b2&.ray_tpu_torch.protocol.ObjectLocation\x12\x11\n\tcontained\x18\x03 \x03(\x0c"\xca\x02\n\x08TaskDone\x120\n\x05seals\x18\x01 \x03(\x0b2!.ray_tpu_torch.protocol.SealEntry\x12\x0f\n\x07task_id\x18\x02 \x01(\x0c\x12\x12\n\nreturn_ids\x18\x03 \x03(\x0c\x12\x19\n\x11is_actor_creation\x18\x04 \x01(\x08\x12\x15\n\x08actor_id\x18\x05 \x01(\x0cH\x00\x88\x01\x01\x12\x11\n\x04name\x18\x06 \x01(\tH\x01\x88\x01\x01\x12\x0e\n\x06failed\x18\x07 \x01(\x08\x12\x16\n\terror_str\x18\x08 \x01(\tH\x02\x88\x01\x01\x12\x12\n\nexec_start\x18\t \x01(\x01\x12\x10\n\x08exec_end\x18\n \x01(\x01\x12\x12\n\nworker_pid\x18\x0b \x01(\x05\x12\x12\n\x05extra\x18\x0c \x01(\x0cH\x03\x88\x01\x01B\x0b\n\t_actor_idB\x07\n\x05_nameB\x0c\n\n_error_strB\x08\n\x06_extra"\x19\n\tRefUpdate\x12\x0c\n\x04oids\x18\x01 \x03(\x0c"/\n\x05KvPut\x12\n\n\x02ns\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c"0\n\x05KvGet\x12\n\n\x02ns\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\x0e\n\x06req_id\x18\x03 \x01(\x04"N\n\x0cGetLocations\x12\x0c\n\x04oids\x18\x01 \x03(\x0c\x12\x14\n\x07timeout\x18\x02 \x01(\x01H\x00\x88\x01\x01\x12\x0e\n\x06req_id\x18\x03 \x01(\x04B\n\n\x08_timeout"[\n\x04Wait\x12\x0c\n\x04oids\x18\x01 \x03(\x0c\x12\x13\n\x0bnum_returns\x18\x02 \x01(\x05\x12\x14\n\x07timeout\x18\x03 \x01(\x01H\x00\x88\x01\x01\x12\x0e\n\x06req_id\x18\x04 \x01(\x04B\n\n\x08_timeout"\x86\x01\n\x0eLocationsReply\x12\x0e\n\x06req_id\x18\x01 \x01(\x04\x12\x0f\n\x07timeout\x18\x02 \x01(\x08\x123\n\tlocations\x18\x03 \x03(\x0b2 .ray_tpu_torch.protocol.LocEntry\x12\r\n\x05ready\x18\x04 \x03(\x0c\x12\x0f\n\x07is_wait\x18\x05 \x01(\x08"\x16\n\x06Simple\x12\x0c\n\x04type\x18\x01 \x01(\t"\xc4\x05\n\x08Envelope\x12\x0f\n\x07version\x18\x01 \x01(\r\x12\x11\n\x07pickled\x18\x02 \x01(\x0cH\x00\x12;\n\x0csubmit_batch\x18\x03 \x01(\x0b2#.ray_tpu_torch.protocol.SubmitBatchH\x00\x122\n\x07execute\x18\x04 \x01(\x0b2\x1f.ray_tpu_torch.protocol.ExecuteH\x00\x125\n\ttask_done\x18\x05 \x01(\x0b2 .ray_tpu_torch.protocol.TaskDoneH\x00\x121\n\x04seal\x18\x06 \x01(\x0b2!.ray_tpu_torch.protocol.SealEntryH\x00\x124\n\x07add_ref\x18\x07 \x01(\x0b2!.ray_tpu_torch.protocol.RefUpdateH\x00\x127\n\nremove_ref\x18\x08 \x01(\x0b2!.ray_tpu_torch.protocol.RefUpdateH\x00\x12/\n\x06kv_put\x18\t \x01(\x0b2\x1d.ray_tpu_torch.protocol.KvPutH\x00\x12/\n\x06kv_get\x18\n \x01(\x0b2\x1d.ray_tpu_torch.protocol.KvGetH\x00\x12=\n\rget_locations\x18\x0b \x01(\x0b2$.ray_tpu_torch.protocol.GetLocationsH\x00\x12,\n\x04wait\x18\x0c \x01(\x0b2\x1c.ray_tpu_torch.protocol.WaitH\x00\x12A\n\x0flocations_reply\x18\r \x01(\x0b2&.ray_tpu_torch.protocol.LocationsReplyH\x00\x120\n\x06simple\x18\x0e \x01(\x0b2\x1e.ray_tpu_torch.protocol.SimpleH\x00B\x06\n\x04bodyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ray_tpu_torch_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TASKSPEC_RESOURCESENTRY._options = None
  _TASKSPEC_RESOURCESENTRY._serialized_options = b'8\001'
  _OBJECTLOCATION._serialized_start=48
  _OBJECTLOCATION._serialized_end=382
  _TASKSPEC._serialized_start=385
  _TASKSPEC._serialized_end=1198
  _TASKSPEC_RESOURCESENTRY._serialized_start=1000
  _TASKSPEC_RESOURCESENTRY._serialized_end=1048
  _SUBMIT._serialized_start=1200
  _SUBMIT._serialized_end=1270
  _SUBMITBATCH._serialized_start=1272
  _SUBMITBATCH._serialized_end=1332
  _LOCENTRY._serialized_start=1334
  _LOCENTRY._serialized_end=1410
  _EXECUTE._serialized_start=1413
  _EXECUTE._serialized_end=1547
  _SEALENTRY._serialized_start=1549
  _SEALENTRY._serialized_end=1645
  _TASKDONE._serialized_start=1648
  _TASKDONE._serialized_end=1978
  _REFUPDATE._serialized_start=1980
  _REFUPDATE._serialized_end=2005
  _KVPUT._serialized_start=2007
  _KVPUT._serialized_end=2054
  _KVGET._serialized_start=2056
  _KVGET._serialized_end=2104
  _GETLOCATIONS._serialized_start=2106
  _GETLOCATIONS._serialized_end=2184
  _WAIT._serialized_start=2186
  _WAIT._serialized_end=2277
  _LOCATIONSREPLY._serialized_start=2280
  _LOCATIONSREPLY._serialized_end=2414
  _SIMPLE._serialized_start=2416
  _SIMPLE._serialized_end=2438
  _ENVELOPE._serialized_start=2441
  _ENVELOPE._serialized_end=3149
# @@protoc_insertion_point(module_scope)
