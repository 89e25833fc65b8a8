package io.github.pcodec;

/**
 * A typed array of numbers: a Java primitive array plus its pcodec dtype.
 *
 * Types without a Java primitive (u16/u32/u64, f16) ride the signed integer
 * primitive of the same width; pcodec treats the payload as raw bits, so no
 * information is lost. API-compatible with the reference binding
 * (ref: pco_java/src/main/java/io/github/pcodec/NumArray.java).
 */
public class NumArray {
    public final Object nums;
    private final byte numberTypeByte;

    NumArray(Object nums, byte numberTypeByte) {
        this.nums = nums;
        this.numberTypeByte = numberTypeByte;
    }

    public NumberType numberType() {
        return NumberType.fromByte(numberTypeByte);
    }

    private static NumArray of(Object nums, NumberType t) {
        return new NumArray(nums, t.byte_);
    }

    public static NumArray i8Array(byte[] nums) { return of(nums, NumberType.I8); }
    public static NumArray i16Array(short[] nums) { return of(nums, NumberType.I16); }
    public static NumArray i32Array(int[] nums) { return of(nums, NumberType.I32); }
    public static NumArray i64Array(long[] nums) { return of(nums, NumberType.I64); }
    public static NumArray u8Array(byte[] nums) { return of(nums, NumberType.U8); }
    public static NumArray u16Array(short[] nums) { return of(nums, NumberType.U16); }
    public static NumArray u32Array(int[] nums) { return of(nums, NumberType.U32); }
    public static NumArray u64Array(long[] nums) { return of(nums, NumberType.U64); }
    public static NumArray f16Array(short[] nums) { return of(nums, NumberType.F16); }
    public static NumArray f32Array(float[] nums) { return of(nums, NumberType.F32); }
    public static NumArray f64Array(double[] nums) { return of(nums, NumberType.F64); }

    private Object cast(NumberType want) {
        if (numberTypeByte != want.byte_) {
            throw new IllegalStateException(
                "Cannot cast pco NumArray of " + numberType() + " to " + want);
        }
        return nums;
    }

    public byte[] as_i8_array() { return (byte[]) cast(NumberType.I8); }
    public short[] as_i16_array() { return (short[]) cast(NumberType.I16); }
    public int[] as_i32_array() { return (int[]) cast(NumberType.I32); }
    public long[] as_i64_array() { return (long[]) cast(NumberType.I64); }
    public byte[] as_u8_array() { return (byte[]) cast(NumberType.U8); }
    public short[] as_u16_array() { return (short[]) cast(NumberType.U16); }
    public int[] as_u32_array() { return (int[]) cast(NumberType.U32); }
    public long[] as_u64_array() { return (long[]) cast(NumberType.U64); }
    public short[] as_f16_array() { return (short[]) cast(NumberType.F16); }
    public float[] as_f32_array() { return (float[]) cast(NumberType.F32); }
    public double[] as_f64_array() { return (double[]) cast(NumberType.F64); }
}
