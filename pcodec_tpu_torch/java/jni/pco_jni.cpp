// JNI shim for io.github.pcodec.Standalone over the pcodec_tpu_torch C ABI
// (native/cpcodec.h) — the pco_java equivalent
// (ref: pco_java/src/main/rust/src/lib.rs:116-135).
//
// Build (requires a JDK for jni.h; see java/README.md):
//   g++ -O2 -shared -fPIC pco_jni.cpp -I$JAVA_HOME/include
//       -I$JAVA_HOME/include/linux -L<dir of libcpcodec.so> -lcpcodec
//       -o libpco_tpu_java.so
// Compile verification without a JDK: `make syntax-check` (jni_stub/).

#include <jni.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "../../native/cpcodec.h"

namespace {

void throw_java(JNIEnv* env, const char* cls, const std::string& msg) {
  jclass c = env->FindClass(cls);
  if (c) env->ThrowNew(c, msg.c_str());
}

// Java primitive-array class + element width per pco number type byte
struct TypeInfo {
  const char* jni_sig;  // e.g. "[J"
  int width;
};

bool type_info(int tb, TypeInfo* out) {
  switch (tb) {
    case 10: case 11: *out = {"[B", 1}; return true;  // u8, i8
    case 7: case 8: case 9: *out = {"[S", 2}; return true;  // u16, i16, f16
    case 1: case 3: *out = {"[I", 4}; return true;  // u32, i32
    case 5: *out = {"[F", 4}; return true;  // f32
    case 2: case 4: *out = {"[J", 8}; return true;  // u64, i64
    case 6: *out = {"[D", 8}; return true;  // f64
    default: return false;
  }
}

// Copy the primitive array out of a NumArray into a byte vector.
bool num_array_payload(JNIEnv* env, jobject num_array, int* type_byte,
                       std::vector<uint8_t>* bytes, size_t* n_elems) {
  jclass cls = env->GetObjectClass(num_array);
  jmethodID mid = env->GetMethodID(cls, "numberType",
                                   "()Lio/github/pcodec/NumberType;");
  if (!mid) return false;
  jobject jtype = env->CallObjectMethod(num_array, mid);
  jclass tcls = env->GetObjectClass(jtype);
  jfieldID bfid = env->GetFieldID(tcls, "byte_", "B");
  *type_byte = env->GetByteField(jtype, bfid);

  jfieldID nfid = env->GetFieldID(cls, "nums", "Ljava/lang/Object;");
  jobject nums = env->GetObjectField(num_array, nfid);
  jarray arr = static_cast<jarray>(nums);
  jsize len = env->GetArrayLength(arr);
  *n_elems = static_cast<size_t>(len);

  TypeInfo ti;
  if (!type_info(*type_byte, &ti)) return false;
  bytes->resize(static_cast<size_t>(len) * ti.width);
  void* p = env->GetPrimitiveArrayCritical(arr, nullptr);
  if (!p) return false;
  std::memcpy(bytes->data(), p, bytes->size());
  env->ReleasePrimitiveArrayCritical(arr, p, JNI_ABORT);
  return true;
}

jobject make_num_array(JNIEnv* env, int type_byte, const void* data, size_t n) {
  TypeInfo ti;
  if (!type_info(type_byte, &ti)) return nullptr;
  jarray arr;
  switch (ti.jni_sig[1]) {
    case 'B': arr = env->NewByteArray(n); break;
    case 'S': arr = env->NewShortArray(n); break;
    case 'I': arr = env->NewIntArray(n); break;
    case 'F': arr = env->NewFloatArray(n); break;
    case 'J': arr = env->NewLongArray(n); break;
    default: arr = env->NewDoubleArray(n); break;
  }
  if (!arr) return nullptr;
  if (n) {
    void* p = env->GetPrimitiveArrayCritical(arr, nullptr);
    if (!p) return nullptr;
    std::memcpy(p, data, n * ti.width);
    env->ReleasePrimitiveArrayCritical(arr, p, 0);
  }
  jclass cls = env->FindClass("io/github/pcodec/NumArray");
  jmethodID ctor = env->GetMethodID(cls, "<init>", "(Ljava/lang/Object;B)V");
  return env->NewObject(cls, ctor, arr, static_cast<jbyte>(type_byte));
}

}  // namespace

extern "C" {

JNIEXPORT jbyteArray JNICALL Java_io_github_pcodec_Standalone_simple_1compress(
    JNIEnv* env, jclass, jobject j_num_array, jobject j_config) {
  int type_byte = 0;
  std::vector<uint8_t> payload;
  size_t n = 0;
  if (!num_array_payload(env, j_num_array, &type_byte, &payload, &n)) {
    throw_java(env, "java/lang/IllegalArgumentException", "bad NumArray");
    return nullptr;
  }
  int level = 8;
  if (j_config) {
    jclass ccls = env->GetObjectClass(j_config);
    jfieldID lf = env->GetFieldID(ccls, "compressionLevel", "I");
    if (lf) level = env->GetIntField(j_config, lf);
  }
  size_t cap = pco_standalone_guarantee_file_size(
      static_cast<unsigned char>(type_byte), n);
  std::vector<uint8_t> dst(cap);
  size_t written = 0;
  int rc = pco_standalone_simple_compress_into(
      payload.data(), n, static_cast<unsigned char>(type_byte),
      static_cast<unsigned int>(level), dst.data(), cap, &written);
  if (rc != PCO_SUCCESS) {
    throw_java(env, "java/lang/IllegalArgumentException",
               "pco compression failed with code " + std::to_string(rc));
    return nullptr;
  }
  jbyteArray out = env->NewByteArray(written);
  if (out) {
    env->SetByteArrayRegion(out, 0, written,
                            reinterpret_cast<const jbyte*>(dst.data()));
  }
  return out;
}

JNIEXPORT jobject JNICALL Java_io_github_pcodec_Standalone_simple_1decompress(
    JNIEnv* env, jclass, jbyteArray j_src) {
  jsize src_len = env->GetArrayLength(j_src);
  std::vector<uint8_t> src(src_len);
  env->GetByteArrayRegion(j_src, 0, src_len,
                          reinterpret_cast<jbyte*>(src.data()));

  unsigned char type_byte = 0;
  void* data = nullptr;
  size_t n = 0;
  int rc = pco_standalone_simple_decompress_alloc(src.data(), src.size(),
                                                  &type_byte, &data, &n);
  if (rc != PCO_SUCCESS) {
    throw_java(env, "java/lang/RuntimeException",
               "pco decompression failed with code " + std::to_string(rc));
    return nullptr;
  }
  jclass opt = env->FindClass("java/util/Optional");
  if (type_byte == 0) {
    jmethodID empty = env->GetStaticMethodID(opt, "empty",
                                             "()Ljava/util/Optional;");
    return env->CallStaticObjectMethod(opt, empty);
  }
  jobject num_array = make_num_array(env, type_byte, data, n);
  pco_free(data);
  if (!num_array) {
    throw_java(env, "java/lang/RuntimeException", "NumArray construction failed");
    return nullptr;
  }
  jmethodID of = env->GetStaticMethodID(
      opt, "of", "(Ljava/lang/Object;)Ljava/util/Optional;");
  return env->CallStaticObjectMethod(opt, of, num_array);
}

}  // extern "C"
