# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: plan.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nplan.proto\x12\x0e\x62laze_tpu.plan\"Z\n\rDataTypeProto\x12\'\n\x02id\x18\x01 \x01(\x0e\x32\x1b.blaze_tpu.plan.TypeIdProto\x12\x11\n\tprecision\x18\x02 \x01(\r\x12\r\n\x05scale\x18\x03 \x01(\r\"Z\n\nFieldProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12,\n\x05\x64type\x18\x02 \x01(\x0b\x32\x1d.blaze_tpu.plan.DataTypeProto\x12\x10\n\x08nullable\x18\x03 \x01(\x08\"9\n\x0bSchemaProto\x12*\n\x06\x66ields\x18\x01 \x03(\x0b\x32\x1a.blaze_tpu.plan.FieldProto\"\xc7\x01\n\x0cLiteralProto\x12,\n\x05\x64type\x18\x01 \x01(\x0b\x32\x1d.blaze_tpu.plan.DataTypeProto\x12\x0f\n\x07is_null\x18\x02 \x01(\x08\x12\x14\n\nbool_value\x18\x03 \x01(\x08H\x00\x12\x13\n\tint_value\x18\x04 \x01(\x03H\x00\x12\x15\n\x0b\x66loat_value\x18\x05 \x01(\x01H\x00\x12\x16\n\x0cstring_value\x18\x06 \x01(\tH\x00\x12\x15\n\x0b\x62ytes_value\x18\x07 \x01(\x0cH\x00\x42\x07\n\x05value\"\xcf\x05\n\tExprProto\x12\x10\n\x06\x63olumn\x18\x01 \x01(\tH\x00\x12\x16\n\x0c\x62ound_column\x18\x02 \x01(\rH\x00\x12/\n\x07literal\x18\x03 \x01(\x0b\x32\x1c.blaze_tpu.plan.LiteralProtoH\x00\x12)\n\x04\x63\x61st\x18\x04 \x01(\x0b\x32\x19.blaze_tpu.plan.CastProtoH\x00\x12-\n\x06\x62inary\x18\x05 \x01(\x0b\x32\x1b.blaze_tpu.plan.BinaryProtoH\x00\x12\x30\n\x0blogical_not\x18\x06 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProtoH\x00\x12+\n\x06negate\x18\x07 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProtoH\x00\x12,\n\x07is_null\x18\x08 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProtoH\x00\x12\x30\n\x0bis_not_null\x18\t \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProtoH\x00\x12.\n\x07in_list\x18\n \x01(\x0b\x32\x1b.blaze_tpu.plan.InListProtoH\x00\x12&\n\x03if_\x18\x0b \x01(\x0b\x32\x17.blaze_tpu.plan.IfProtoH\x00\x12*\n\x05\x63\x61se_\x18\x0c \x01(\x0b\x32\x19.blaze_tpu.plan.CaseProtoH\x00\x12\x32\n\tscalar_fn\x18\r \x01(\x0b\x32\x1d.blaze_tpu.plan.ScalarFnProtoH\x00\x12\x31\n\x08\x63oalesce\x18\x0e \x01(\x0b\x32\x1d.blaze_tpu.plan.CoalesceProtoH\x00\x12\'\n\x03\x61gg\x18\x0f \x01(\x0b\x32\x18.blaze_tpu.plan.AggProtoH\x00\x12\x32\n\x0b\x62ound_dtype\x18\x14 \x01(\x0b\x32\x1d.blaze_tpu.plan.DataTypeProtoB\x06\n\x04kind\"`\n\tCastProto\x12(\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12)\n\x02to\x18\x02 \x01(\x0b\x32\x1d.blaze_tpu.plan.DataTypeProto\"\x8b\x01\n\x0b\x42inaryProto\x12)\n\x02op\x18\x01 \x01(\x0e\x32\x1d.blaze_tpu.plan.BinaryOpProto\x12\'\n\x04left\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12(\n\x05right\x18\x03 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\"s\n\x0bInListProto\x12(\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12)\n\x06values\x18\x02 \x03(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12\x0f\n\x07negated\x18\x03 \x01(\x08\"\x89\x01\n\x07IfProto\x12\'\n\x04\x63ond\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12\'\n\x04then\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12,\n\totherwise\x18\x03 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\"\xcb\x01\n\tCaseProto\x12\x32\n\x08\x62ranches\x18\x01 \x03(\x0b\x32 .blaze_tpu.plan.CaseProto.Branch\x12,\n\totherwise\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x1a\\\n\x06\x42ranch\x12\'\n\x04\x63ond\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12)\n\x06result\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\"F\n\rScalarFnProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\'\n\x04\x61rgs\x18\x02 \x03(\x0b\x32\x19.blaze_tpu.plan.ExprProto\"8\n\rCoalesceProto\x12\'\n\x04\x61rgs\x18\x01 \x03(\x0b\x32\x19.blaze_tpu.plan.ExprProto\"\\\n\x08\x41ggProto\x12&\n\x02\x66n\x18\x01 \x01(\x0e\x32\x1a.blaze_tpu.plan.AggFnProto\x12(\n\x05\x63hild\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\"G\n\x0eNamedExprProto\x12\'\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12\x0c\n\x04name\x18\x02 \x01(\t\"\xe9\x06\n\tPlanProto\x12\x38\n\x0cparquet_scan\x18\x01 \x01(\x0b\x32 .blaze_tpu.plan.ParquetScanProtoH\x00\x12\x34\n\nipc_reader\x18\x02 \x01(\x0b\x32\x1e.blaze_tpu.plan.IpcReaderProtoH\x00\x12@\n\x10\x65mpty_partitions\x18\x03 \x01(\x0b\x32$.blaze_tpu.plan.EmptyPartitionsProtoH\x00\x12/\n\x07project\x18\x04 \x01(\x0b\x32\x1c.blaze_tpu.plan.ProjectProtoH\x00\x12-\n\x06\x66ilter\x18\x05 \x01(\x0b\x32\x1b.blaze_tpu.plan.FilterProtoH\x00\x12)\n\x04sort\x18\x06 \x01(\x0b\x32\x19.blaze_tpu.plan.SortProtoH\x00\x12+\n\x05union\x18\x07 \x01(\x0b\x32\x1a.blaze_tpu.plan.UnionProtoH\x00\x12+\n\x05limit\x18\x08 \x01(\x0b\x32\x1a.blaze_tpu.plan.LimitProtoH\x00\x12<\n\x0ehash_aggregate\x18\t \x01(\x0b\x32\".blaze_tpu.plan.HashAggregateProtoH\x00\x12\x32\n\thash_join\x18\n \x01(\x0b\x32\x1d.blaze_tpu.plan.HashJoinProtoH\x00\x12=\n\x0fsort_merge_join\x18\x0b \x01(\x0b\x32\".blaze_tpu.plan.SortMergeJoinProtoH\x00\x12<\n\x0eshuffle_writer\x18\x0c \x01(\x0b\x32\".blaze_tpu.plan.ShuffleWriterProtoH\x00\x12\x34\n\nipc_writer\x18\r \x01(\x0b\x32\x1e.blaze_tpu.plan.IpcWriterProtoH\x00\x12<\n\x0erename_columns\x18\x0e \x01(\x0b\x32\".blaze_tpu.plan.RenameColumnsProtoH\x00\x12+\n\x05\x64\x65\x62ug\x18\x0f \x01(\x0b\x32\x1a.blaze_tpu.plan.DebugProtoH\x00\x12-\n\x06window\x18\x10 \x01(\x0b\x32\x1b.blaze_tpu.plan.WindowProtoH\x00\x42\x06\n\x04kind\"8\n\tFileRange\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\r\n\x05start\x18\x02 \x01(\x03\x12\x0e\n\x06length\x18\x03 \x01(\x03\":\n\x0e\x46ileGroupProto\x12(\n\x05\x66iles\x18\x01 \x03(\x0b\x32\x19.blaze_tpu.plan.FileRange\"\xbe\x01\n\x10ParquetScanProto\x12\x33\n\x0b\x66ile_groups\x18\x01 \x03(\x0b\x32\x1e.blaze_tpu.plan.FileGroupProto\x12+\n\x06schema\x18\x02 \x01(\x0b\x32\x1b.blaze_tpu.plan.SchemaProto\x12\x12\n\nprojection\x18\x03 \x03(\r\x12\x34\n\x11pruning_predicate\x18\x04 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\"\x9a\x01\n\x0eIpcReaderProto\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12+\n\x06schema\x18\x02 \x01(\x0b\x32\x1b.blaze_tpu.plan.SchemaProto\x12\x16\n\x0enum_partitions\x18\x03 \x01(\r\x12.\n\x04mode\x18\x04 \x01(\x0e\x32 .blaze_tpu.plan.IpcReadModeProto\"[\n\x14\x45mptyPartitionsProto\x12+\n\x06schema\x18\x01 \x01(\x0b\x32\x1b.blaze_tpu.plan.SchemaProto\x12\x16\n\x0enum_partitions\x18\x02 \x01(\r\"g\n\x0cProjectProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12-\n\x05\x65xprs\x18\x02 \x03(\x0b\x32\x1e.blaze_tpu.plan.NamedExprProto\"e\n\x0b\x46ilterProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12,\n\tpredicate\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\"_\n\x0cSortKeyProto\x12\'\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12\x11\n\tascending\x18\x02 \x01(\x08\x12\x13\n\x0bnulls_first\x18\x03 \x01(\x08\"p\n\tSortProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12*\n\x04keys\x18\x02 \x03(\x0b\x32\x1c.blaze_tpu.plan.SortKeyProto\x12\r\n\x05\x66\x65tch\x18\x03 \x01(\x03\"7\n\nUnionProto\x12)\n\x06inputs\x18\x01 \x03(\x0b\x32\x19.blaze_tpu.plan.PlanProto\"E\n\nLimitProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12\r\n\x05limit\x18\x02 \x01(\x03\"\xc6\x01\n\x12HashAggregateProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12,\n\x04keys\x18\x02 \x03(\x0b\x32\x1e.blaze_tpu.plan.NamedExprProto\x12,\n\x04\x61ggs\x18\x03 \x03(\x0b\x32\x1e.blaze_tpu.plan.NamedExprProto\x12*\n\x04mode\x18\x04 \x01(\x0e\x32\x1c.blaze_tpu.plan.AggModeProto\"\xbb\x01\n\rHashJoinProto\x12\'\n\x04left\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12(\n\x05right\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12\x11\n\tleft_keys\x18\x03 \x03(\t\x12\x12\n\nright_keys\x18\x04 \x03(\t\x12\x30\n\tjoin_type\x18\x05 \x01(\x0e\x32\x1d.blaze_tpu.plan.JoinTypeProto\"\xd3\x01\n\x12SortMergeJoinProto\x12\'\n\x04left\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12(\n\x05right\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12\x11\n\tleft_keys\x18\x03 \x03(\t\x12\x12\n\nright_keys\x18\x04 \x03(\t\x12\x30\n\tjoin_type\x18\x05 \x01(\x0e\x32\x1d.blaze_tpu.plan.JoinTypeProto\x12\x11\n\tstreaming\x18\x06 \x01(\x08\"?\n\x0fRangeBoundProto\x12,\n\x06values\x18\x01 \x03(\x0b\x32\x1c.blaze_tpu.plan.LiteralProto\"\xa5\x02\n\x12ShuffleWriterProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12\'\n\x04keys\x18\x02 \x03(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12\x16\n\x0enum_partitions\x18\x03 \x01(\r\x12\x11\n\tdata_file\x18\x04 \x01(\t\x12\x12\n\nindex_file\x18\x05 \x01(\t\x12.\n\x04mode\x18\x06 \x01(\x0e\x32 .blaze_tpu.plan.ShuffleModeProto\x12\x35\n\x0crange_bounds\x18\x07 \x03(\x0b\x32\x1f.blaze_tpu.plan.RangeBoundProto\x12\x16\n\x0esort_ascending\x18\x08 \x03(\x08\"O\n\x0eIpcWriterProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12\x13\n\x0bresource_id\x18\x02 \x01(\t\"M\n\x12RenameColumnsProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12\r\n\x05names\x18\x02 \x03(\t\"H\n\nDebugProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12\x10\n\x08\x64\x65\x62ug_id\x18\x02 \x01(\t\"\x9b\x01\n\rWindowFnProto\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12)\n\x06source\x18\x02 \x01(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12\x0e\n\x06output\x18\x03 \x01(\t\x12\x0e\n\x06offset\x18\x04 \x01(\x03\x12\r\n\x05\x66rame\x18\x05 \x01(\t\x12\x10\n\x08\x66rame_lo\x18\x06 \x01(\x03\x12\x10\n\x08\x66rame_hi\x18\x07 \x01(\x03\"\xca\x01\n\x0bWindowProto\x12(\n\x05input\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12/\n\x0cpartition_by\x18\x02 \x03(\x0b\x32\x19.blaze_tpu.plan.ExprProto\x12.\n\x08order_by\x18\x03 \x03(\x0b\x32\x1c.blaze_tpu.plan.SortKeyProto\x12\x30\n\tfunctions\x18\x04 \x03(\x0b\x32\x1d.blaze_tpu.plan.WindowFnProto\"\x88\x01\n\x15ResourceSegmentsProto\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12+\n\x08segments\x18\x02 \x03(\x0b\x32\x19.blaze_tpu.plan.FileRange\x12-\n\x07ordered\x18\x03 \x03(\x0b\x32\x1c.blaze_tpu.plan.SegmentProto\"x\n\x0cSegmentProto\x12*\n\x05local\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.FileRangeH\x00\x12\x34\n\x06remote\x18\x02 \x01(\x0b\x32\".blaze_tpu.plan.RemoteSegmentProtoH\x00\x42\x06\n\x04kind\"]\n\x12RemoteSegmentProto\x12\x0c\n\x04host\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x0c\n\x04path\x18\x03 \x01(\t\x12\r\n\x05start\x18\x04 \x01(\x03\x12\x0e\n\x06length\x18\x05 \x01(\x03\"\xa1\x01\n\x13TaskDefinitionProto\x12\'\n\x04plan\x18\x01 \x01(\x0b\x32\x19.blaze_tpu.plan.PlanProto\x12\x11\n\tpartition\x18\x02 \x01(\r\x12\x0f\n\x07task_id\x18\x03 \x01(\t\x12=\n\x0e\x66ile_resources\x18\x04 \x03(\x0b\x32%.blaze_tpu.plan.ResourceSegmentsProto*\xa7\x01\n\x0bTypeIdProto\x12\x08\n\x04NULL\x10\x00\x12\x08\n\x04\x42OOL\x10\x01\x12\x08\n\x04INT8\x10\x02\x12\t\n\x05INT16\x10\x03\x12\t\n\x05INT32\x10\x04\x12\t\n\x05INT64\x10\x05\x12\x0b\n\x07\x46LOAT32\x10\x06\x12\x0b\n\x07\x46LOAT64\x10\x07\x12\x08\n\x04UTF8\x10\x08\x12\n\n\x06\x42INARY\x10\t\x12\n\n\x06\x44\x41TE32\x10\n\x12\x10\n\x0cTIMESTAMP_US\x10\x0b\x12\x0b\n\x07\x44\x45\x43IMAL\x10\x0c*\xb5\x01\n\rBinaryOpProto\x12\x07\n\x03\x41\x44\x44\x10\x00\x12\x07\n\x03SUB\x10\x01\x12\x07\n\x03MUL\x10\x02\x12\x07\n\x03\x44IV\x10\x03\x12\x07\n\x03MOD\x10\x04\x12\x06\n\x02\x45Q\x10\x05\x12\x07\n\x03NEQ\x10\x06\x12\x06\n\x02LT\x10\x07\x12\x07\n\x03LTE\x10\x08\x12\x06\n\x02GT\x10\t\x12\x07\n\x03GTE\x10\n\x12\x07\n\x03\x41ND\x10\x0b\x12\x06\n\x02OR\x10\x0c\x12\n\n\x06\x42ITAND\x10\r\x12\t\n\x05\x42ITOR\x10\x0e\x12\n\n\x06\x42ITXOR\x10\x0f\x12\x07\n\x03SHL\x10\x10\x12\x07\n\x03SHR\x10\x11*\x9c\x01\n\nAggFnProto\x12\x07\n\x03MIN\x10\x00\x12\x07\n\x03MAX\x10\x01\x12\x07\n\x03SUM\x10\x02\x12\x07\n\x03\x41VG\x10\x03\x12\t\n\x05\x43OUNT\x10\x04\x12\x0e\n\nCOUNT_STAR\x10\x05\x12\x0c\n\x08VAR_SAMP\x10\x06\x12\x0b\n\x07VAR_POP\x10\x07\x12\x0f\n\x0bSTDDEV_SAMP\x10\x08\x12\x0e\n\nSTDDEV_POP\x10\t\x12\t\n\x05\x46IRST\x10\n\x12\x08\n\x04LAST\x10\x0b*W\n\x10IpcReadModeProto\x12\x0b\n\x07\x43HANNEL\x10\x00\x12\x18\n\x14\x43HANNEL_UNCOMPRESSED\x10\x01\x12\x1c\n\x18\x43HANNEL_AND_FILE_SEGMENT\x10\x02*4\n\x0c\x41ggModeProto\x12\x0b\n\x07PARTIAL\x10\x00\x12\t\n\x05\x46INAL\x10\x01\x12\x0c\n\x08\x43OMPLETE\x10\x02*q\n\rJoinTypeProto\x12\t\n\x05INNER\x10\x00\x12\x08\n\x04LEFT\x10\x01\x12\t\n\x05RIGHT\x10\x02\x12\x08\n\x04\x46ULL\x10\x03\x12\r\n\tLEFT_SEMI\x10\x04\x12\r\n\tLEFT_ANTI\x10\x05\x12\x18\n\x14LEFT_ANTI_NULL_AWARE\x10\x06*D\n\x10ShuffleModeProto\x12\x08\n\x04HASH\x10\x00\x12\n\n\x06SINGLE\x10\x01\x12\x0f\n\x0bROUND_ROBIN\x10\x02\x12\t\n\x05RANGE\x10\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'plan_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TYPEIDPROTO._serialized_start=6265
  _TYPEIDPROTO._serialized_end=6432
  _BINARYOPPROTO._serialized_start=6435
  _BINARYOPPROTO._serialized_end=6616
  _AGGFNPROTO._serialized_start=6619
  _AGGFNPROTO._serialized_end=6775
  _IPCREADMODEPROTO._serialized_start=6777
  _IPCREADMODEPROTO._serialized_end=6864
  _AGGMODEPROTO._serialized_start=6866
  _AGGMODEPROTO._serialized_end=6918
  _JOINTYPEPROTO._serialized_start=6920
  _JOINTYPEPROTO._serialized_end=7033
  _SHUFFLEMODEPROTO._serialized_start=7035
  _SHUFFLEMODEPROTO._serialized_end=7103
  _DATATYPEPROTO._serialized_start=30
  _DATATYPEPROTO._serialized_end=120
  _FIELDPROTO._serialized_start=122
  _FIELDPROTO._serialized_end=212
  _SCHEMAPROTO._serialized_start=214
  _SCHEMAPROTO._serialized_end=271
  _LITERALPROTO._serialized_start=274
  _LITERALPROTO._serialized_end=473
  _EXPRPROTO._serialized_start=476
  _EXPRPROTO._serialized_end=1195
  _CASTPROTO._serialized_start=1197
  _CASTPROTO._serialized_end=1293
  _BINARYPROTO._serialized_start=1296
  _BINARYPROTO._serialized_end=1435
  _INLISTPROTO._serialized_start=1437
  _INLISTPROTO._serialized_end=1552
  _IFPROTO._serialized_start=1555
  _IFPROTO._serialized_end=1692
  _CASEPROTO._serialized_start=1695
  _CASEPROTO._serialized_end=1898
  _CASEPROTO_BRANCH._serialized_start=1806
  _CASEPROTO_BRANCH._serialized_end=1898
  _SCALARFNPROTO._serialized_start=1900
  _SCALARFNPROTO._serialized_end=1970
  _COALESCEPROTO._serialized_start=1972
  _COALESCEPROTO._serialized_end=2028
  _AGGPROTO._serialized_start=2030
  _AGGPROTO._serialized_end=2122
  _NAMEDEXPRPROTO._serialized_start=2124
  _NAMEDEXPRPROTO._serialized_end=2195
  _PLANPROTO._serialized_start=2198
  _PLANPROTO._serialized_end=3071
  _FILERANGE._serialized_start=3073
  _FILERANGE._serialized_end=3129
  _FILEGROUPPROTO._serialized_start=3131
  _FILEGROUPPROTO._serialized_end=3189
  _PARQUETSCANPROTO._serialized_start=3192
  _PARQUETSCANPROTO._serialized_end=3382
  _IPCREADERPROTO._serialized_start=3385
  _IPCREADERPROTO._serialized_end=3539
  _EMPTYPARTITIONSPROTO._serialized_start=3541
  _EMPTYPARTITIONSPROTO._serialized_end=3632
  _PROJECTPROTO._serialized_start=3634
  _PROJECTPROTO._serialized_end=3737
  _FILTERPROTO._serialized_start=3739
  _FILTERPROTO._serialized_end=3840
  _SORTKEYPROTO._serialized_start=3842
  _SORTKEYPROTO._serialized_end=3937
  _SORTPROTO._serialized_start=3939
  _SORTPROTO._serialized_end=4051
  _UNIONPROTO._serialized_start=4053
  _UNIONPROTO._serialized_end=4108
  _LIMITPROTO._serialized_start=4110
  _LIMITPROTO._serialized_end=4179
  _HASHAGGREGATEPROTO._serialized_start=4182
  _HASHAGGREGATEPROTO._serialized_end=4380
  _HASHJOINPROTO._serialized_start=4383
  _HASHJOINPROTO._serialized_end=4570
  _SORTMERGEJOINPROTO._serialized_start=4573
  _SORTMERGEJOINPROTO._serialized_end=4784
  _RANGEBOUNDPROTO._serialized_start=4786
  _RANGEBOUNDPROTO._serialized_end=4849
  _SHUFFLEWRITERPROTO._serialized_start=4852
  _SHUFFLEWRITERPROTO._serialized_end=5145
  _IPCWRITERPROTO._serialized_start=5147
  _IPCWRITERPROTO._serialized_end=5226
  _RENAMECOLUMNSPROTO._serialized_start=5228
  _RENAMECOLUMNSPROTO._serialized_end=5305
  _DEBUGPROTO._serialized_start=5307
  _DEBUGPROTO._serialized_end=5379
  _WINDOWFNPROTO._serialized_start=5382
  _WINDOWFNPROTO._serialized_end=5537
  _WINDOWPROTO._serialized_start=5540
  _WINDOWPROTO._serialized_end=5742
  _RESOURCESEGMENTSPROTO._serialized_start=5745
  _RESOURCESEGMENTSPROTO._serialized_end=5881
  _SEGMENTPROTO._serialized_start=5883
  _SEGMENTPROTO._serialized_end=6003
  _REMOTESEGMENTPROTO._serialized_start=6005
  _REMOTESEGMENTPROTO._serialized_end=6098
  _TASKDEFINITIONPROTO._serialized_start=6101
  _TASKDEFINITIONPROTO._serialized_end=6262
# @@protoc_insertion_point(module_scope)
