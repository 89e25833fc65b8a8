package io.github.pcodec;

import java.util.HashMap;
import java.util.Map;

/**
 * One of the numeric dtypes pcodec supports, identified by its wire byte.
 *
 * Byte values follow the Pco format's number-type table
 * (ref: pco/src/data_types: u32=1 u64=2 i32=3 i64=4 f32=5 f64=6
 * u16=7 i16=8 f16=9 u8=10 i8=11).
 */
public enum NumberType {
    U32((byte) 1),
    U64((byte) 2),
    I32((byte) 3),
    I64((byte) 4),
    F32((byte) 5),
    F64((byte) 6),
    U16((byte) 7),
    I16((byte) 8),
    F16((byte) 9),
    U8((byte) 10),
    I8((byte) 11);

    public final byte byte_;

    private static final Map<Byte, NumberType> BY_BYTE = new HashMap<>();

    static {
        for (NumberType t : values()) {
            BY_BYTE.put(t.byte_, t);
        }
    }

    NumberType(byte byte_) {
        this.byte_ = byte_;
    }

    public static NumberType fromByte(int byte_) {
        NumberType t = BY_BYTE.get((byte) byte_);
        if (t == null) {
            throw new IllegalArgumentException("Invalid number type byte: " + byte_);
        }
        return t;
    }

    /** Width in bytes of one number of this type. */
    public int byteWidth() {
        switch (this) {
            case U8:
            case I8:
                return 1;
            case U16:
            case I16:
            case F16:
                return 2;
            case U32:
            case I32:
            case F32:
                return 4;
            default:
                return 8;
        }
    }
}
