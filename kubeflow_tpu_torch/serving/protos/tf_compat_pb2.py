# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tf_compat.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




# protoc's serialized descriptor, wrapped at 88 columns.
DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
    b'\n\x0ftf_compat.proto\x12\x0ckft.tfcompat"|\n\x10TensorShapeProto\x12/\n'
    b'\x03dim\x18\x02 \x03(\x0b2".kft.tfcompat.TensorShapeProto.Dim\x12\x14\n'
    b'\x0cunknown_rank\x18\x03 \x01(\x08\x1a!\n\x03Dim\x12\x0c\n\x04size\x18'
    b'\x01 \x01(\x03\x12\x0c\n\x04name\x18\x02 \x01(\t"\xcd\x02\n\x0bTensorProt'
    b'o\x12\r\n\x05dtype\x18\x01 \x01(\x05\x124\n\x0ctensor_shape\x18\x02 \x01('
    b'\x0b2\x1e.kft.tfcompat.TensorShapeProto\x12\x16\n\x0eversion_number\x18'
    b'\x03 \x01(\x05\x12\x16\n\x0etensor_content\x18\x04 \x01(\x0c\x12\x14\n'
    b'\x08half_val\x18\r \x03(\x05B\x02\x10\x01\x12\x15\n\tfloat_val\x18\x05 '
    b'\x03(\x02B\x02\x10\x01\x12\x16\n\ndouble_val\x18\x06 \x03(\x01B\x02\x10'
    b'\x01\x12\x13\n\x07int_val\x18\x07 \x03(\x05B\x02\x10\x01\x12\x12\n\nstrin'
    b'g_val\x18\x08 \x03(\x0c\x12\x15\n\tint64_val\x18\n \x03(\x03B\x02\x10\x01'
    b'\x12\x14\n\x08bool_val\x18\x0b \x03(\x08B\x02\x10\x01\x12\x16\n\nuint32_v'
    b'al\x18\x10 \x03(\rB\x02\x10\x01\x12\x16\n\nuint64_val\x18\x11 \x03(\x04B'
    b'\x02\x10\x01"\x1b\n\nInt64Value\x12\r\n\x05value\x18\x01 \x01(\x03"s\n\tM'
    b'odelSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12)\n\x07version\x18\x02 \x01'
    b'(\x0b2\x18.kft.tfcompat.Int64Value\x12\x16\n\x0esignature_name\x18\x03 '
    b'\x01(\t\x12\x15\n\rversion_label\x18\x04 \x01(\t"\xd8\x01\n\x0ePredictReq'
    b'uest\x12+\n\nmodel_spec\x18\x01 \x01(\x0b2\x17.kft.tfcompat.ModelSpec\x12'
    b'8\n\x06inputs\x18\x02 \x03(\x0b2(.kft.tfcompat.PredictRequest.InputsEntry'
    b'\x12\x15\n\routput_filter\x18\x03 \x03(\t\x1aH\n\x0bInputsEntry\x12\x0b\n'
    b'\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b2\x19.kft.tfcomp'
    b'at.TensorProto:\x028\x01"\xc6\x01\n\x0fPredictResponse\x12+\n\nmodel_spec'
    b'\x18\x02 \x01(\x0b2\x17.kft.tfcompat.ModelSpec\x12;\n\x07outputs\x18\x01 '
    b'\x03(\x0b2*.kft.tfcompat.PredictResponse.OutputsEntry\x1aI\n\x0cOutputsEn'
    b'try\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b2'
    b'\x19.kft.tfcompat.TensorProto:\x028\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tf_compat_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSORPROTO.fields_by_name['half_val']._options = None
  _TENSORPROTO.fields_by_name['half_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['float_val']._options = None
  _TENSORPROTO.fields_by_name['float_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['double_val']._options = None
  _TENSORPROTO.fields_by_name['double_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['int_val']._options = None
  _TENSORPROTO.fields_by_name['int_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['int64_val']._options = None
  _TENSORPROTO.fields_by_name['int64_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['bool_val']._options = None
  _TENSORPROTO.fields_by_name['bool_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['uint32_val']._options = None
  _TENSORPROTO.fields_by_name['uint32_val']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['uint64_val']._options = None
  _TENSORPROTO.fields_by_name['uint64_val']._serialized_options = b'\020\001'
  _PREDICTREQUEST_INPUTSENTRY._options = None
  _PREDICTREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _PREDICTRESPONSE_OUTPUTSENTRY._options = None
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_options = b'8\001'
  _TENSORSHAPEPROTO._serialized_start=33
  _TENSORSHAPEPROTO._serialized_end=157
  _TENSORSHAPEPROTO_DIM._serialized_start=124
  _TENSORSHAPEPROTO_DIM._serialized_end=157
  _TENSORPROTO._serialized_start=160
  _TENSORPROTO._serialized_end=493
  _INT64VALUE._serialized_start=495
  _INT64VALUE._serialized_end=522
  _MODELSPEC._serialized_start=524
  _MODELSPEC._serialized_end=639
  _PREDICTREQUEST._serialized_start=642
  _PREDICTREQUEST._serialized_end=858
  _PREDICTREQUEST_INPUTSENTRY._serialized_start=786
  _PREDICTREQUEST_INPUTSENTRY._serialized_end=858
  _PREDICTRESPONSE._serialized_start=861
  _PREDICTRESPONSE._serialized_end=1059
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_start=986
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_end=1059
# @@protoc_insertion_point(module_scope)
