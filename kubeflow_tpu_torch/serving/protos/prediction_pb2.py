# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: prediction.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




# protoc's serialized descriptor, wrapped at 88 columns.
DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
    b'\n\x10prediction.proto\x12\x0bkft.serving"B\n\tModelSpec\x12\x0c\n\x04nam'
    b'e\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\x12\x16\n\x0esig'
    b'nature_name\x18\x03 \x01(\t"4\n\x06Tensor\x12\r\n\x05dtype\x18\x01 \x01('
    b'\t\x12\r\n\x05shape\x18\x02 \x03(\x03\x12\x0c\n\x04data\x18\x03 \x01(\x0c'
    b'"\xb9\x01\n\x0ePredictRequest\x12*\n\nmodel_spec\x18\x01 \x01(\x0b2\x16.k'
    b"ft.serving.ModelSpec\x127\n\x06inputs\x18\x02 \x03(\x0b2'.kft.serving.Pre"
    b'dictRequest.InputsEntry\x1aB\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 '
    b'\x01(\t\x12"\n\x05value\x18\x02 \x01(\x0b2\x13.kft.serving.Tensor:\x028'
    b'\x01"\xbe\x01\n\x0fPredictResponse\x12*\n\nmodel_spec\x18\x01 \x01(\x0b2'
    b'\x16.kft.serving.ModelSpec\x12:\n\x07outputs\x18\x02 \x03(\x0b2).kft.serv'
    b'ing.PredictResponse.OutputsEntry\x1aC\n\x0cOutputsEntry\x12\x0b\n\x03key'
    b'\x18\x01 \x01(\t\x12"\n\x05value\x18\x02 \x01(\x0b2\x13.kft.serving.Tenso'
    b'r:\x028\x01"\xca\x01\n\x0fClassifyRequest\x12*\n\nmodel_spec\x18\x01 \x01'
    b'(\x0b2\x16.kft.serving.ModelSpec\x128\n\x06inputs\x18\x02 \x03(\x0b2(.kft'
    b'.serving.ClassifyRequest.InputsEntry\x12\r\n\x05top_k\x18\x03 \x01(\x05'
    b'\x1aB\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12"\n\x05value'
    b'\x18\x02 \x01(\x0b2\x13.kft.serving.Tensor:\x028\x01"7\n\x14Classificatio'
    b'nResult\x12\x0f\n\x07classes\x18\x01 \x03(\t\x12\x0e\n\x06scores\x18\x02 '
    b'\x03(\x02"r\n\x10ClassifyResponse\x12*\n\nmodel_spec\x18\x01 \x01(\x0b2'
    b'\x16.kft.serving.ModelSpec\x122\n\x07results\x18\x02 \x03(\x0b2!.kft.serv'
    b'ing.ClassificationResult"E\n\x17GetModelMetadataRequest\x12*\n\nmodel_spe'
    b'c\x18\x01 \x01(\x0b2\x16.kft.serving.ModelSpec"]\n\x18GetModelMetadataRes'
    b'ponse\x12*\n\nmodel_spec\x18\x01 \x01(\x0b2\x16.kft.serving.ModelSpec\x12'
    b'\x15\n\rmetadata_json\x18\x02 \x01(\t2\x83\x02\n\x11PredictionService\x12'
    b'D\n\x07Predict\x12\x1b.kft.serving.PredictRequest\x1a\x1c.kft.serving.Pre'
    b'dictResponse\x12G\n\x08Classify\x12\x1c.kft.serving.ClassifyRequest\x1a'
    b'\x1d.kft.serving.ClassifyResponse\x12_\n\x10GetModelMetadata\x12$.kft.ser'
    b'ving.GetModelMetadataRequest\x1a%.kft.serving.GetModelMetadataResponseb'
    b'\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'prediction_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PREDICTREQUEST_INPUTSENTRY._options = None
  _PREDICTREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _PREDICTRESPONSE_OUTPUTSENTRY._options = None
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_options = b'8\001'
  _CLASSIFYREQUEST_INPUTSENTRY._options = None
  _CLASSIFYREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _MODELSPEC._serialized_start=33
  _MODELSPEC._serialized_end=99
  _TENSOR._serialized_start=101
  _TENSOR._serialized_end=153
  _PREDICTREQUEST._serialized_start=156
  _PREDICTREQUEST._serialized_end=341
  _PREDICTREQUEST_INPUTSENTRY._serialized_start=275
  _PREDICTREQUEST_INPUTSENTRY._serialized_end=341
  _PREDICTRESPONSE._serialized_start=344
  _PREDICTRESPONSE._serialized_end=534
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_start=467
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_end=534
  _CLASSIFYREQUEST._serialized_start=537
  _CLASSIFYREQUEST._serialized_end=739
  _CLASSIFYREQUEST_INPUTSENTRY._serialized_start=275
  _CLASSIFYREQUEST_INPUTSENTRY._serialized_end=341
  _CLASSIFICATIONRESULT._serialized_start=741
  _CLASSIFICATIONRESULT._serialized_end=796
  _CLASSIFYRESPONSE._serialized_start=798
  _CLASSIFYRESPONSE._serialized_end=912
  _GETMODELMETADATAREQUEST._serialized_start=914
  _GETMODELMETADATAREQUEST._serialized_end=983
  _GETMODELMETADATARESPONSE._serialized_start=985
  _GETMODELMETADATARESPONSE._serialized_end=1078
  _PREDICTIONSERVICE._serialized_start=1081
  _PREDICTIONSERVICE._serialized_end=1340
# @@protoc_insertion_point(module_scope)
